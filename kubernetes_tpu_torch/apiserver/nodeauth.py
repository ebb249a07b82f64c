"""Node authorizer (graph-lite).

Reference: plugin/pkg/auth/authorizer/node/node_authorizer.go:1 — a
dedicated authorizer for kubelet identities (user ``system:node:<name>``,
group ``system:nodes``) that scopes every request to the node's own
objects via a graph of node → pods → secrets/configmaps/PVCs edges. This
build keeps the decision table but derives the graph edges on demand from
the store (clusters here are orders of magnitude smaller than the
reference's 5k-node graph-index target; a per-request pod scan is cheap
and always current).

Decision table for node users (everything else: deny):
  * nodes / node leases: read any, write only its OWN
  * pods: read any; create allowed (mirror pods — NodeRestriction
    admission validates the binding); update/patch/delete only pods BOUND
    to this node; ``bindings`` never (binding is the scheduler's verb)
  * secrets / configmaps / persistentvolumeclaims: get only when some pod
    bound to this node references the object (the graph edge)
  * events, certificatesigningrequests: create (status reporting, cert
    renewal)
  * services / endpoints / endpointslices: read (the proxier dataplane)

Non-node users are delegated to the wrapped authorizer (RBAC): the union
semantics of the reference's authorizer chain, with the node decision
authoritative for node users so a broad RBAC group grant can never hand a
kubelet another node's pods.
"""

from __future__ import annotations

from typing import Optional

from .admission import NODE_USER_PREFIX, NODES_GROUP

_READ_VERBS = frozenset({"get", "list", "watch"})
_READ_OK = frozenset(
    {"nodes", "pods", "services", "endpoints", "endpointslices", "csinodes",
     "runtimeclasses"}
)
_GRAPH_KINDS = frozenset({"secrets", "configmaps", "persistentvolumeclaims"})


class NodeAwareAuthorizer:
    """Wraps an RBAC authorizer; node-identity requests get the node
    decision table above (authoritative), everything else delegates."""

    def __init__(self, rbac, server):
        self.rbac = rbac
        self.server = server

    # -- graph edges ---------------------------------------------------------

    def _node_pods(self, node_name: str, namespace: Optional[str]):
        try:
            pods, _ = self.server.list("pods")
        except Exception:
            return []
        return [
            p
            for p in pods
            if p.spec.node_name == node_name
            and (not namespace or p.metadata.namespace == namespace)
        ]

    def _pod_references(self, pod, resource: str, name: str) -> bool:
        # Volume's union members are plain NAME strings (api/objects.py
        # Volume: persistent_volume_claim / config_map / secret)
        for v in pod.spec.volumes:
            if resource == "persistentvolumeclaims":
                if v.persistent_volume_claim == name:
                    return True
            elif resource == "secrets" and v.secret == name:
                return True
            elif resource == "configmaps" and v.config_map == name:
                return True
        return False

    def _graph_allows(
        self, node_name: str, resource: str, namespace: str, name: str
    ) -> bool:
        if not name:
            return False  # no list/watch over graph kinds (reference denies)
        return any(
            self._pod_references(p, resource, name)
            for p in self._node_pods(node_name, namespace)
        )

    def _pod_bound_to(self, node_name: str, namespace: str, name: str) -> bool:
        try:
            pod = self.server.get("pods", namespace or "default", name)
        except Exception:
            # unknown pod: fail CLOSED for writes (the reference denies
            # when the graph has no edge)
            return False
        return pod.spec.node_name == node_name

    # -- decision ------------------------------------------------------------

    def _authorize_node(
        self, node_name: str, verb: str, resource: str, namespace: str, name: str
    ) -> bool:
        if resource in _GRAPH_KINDS:
            return verb == "get" and self._graph_allows(
                node_name, resource, namespace, name
            )
        if resource == "certificatesigningrequests":
            # before the generic read branch: credential renewal needs
            # create + get (poll for the signed credential)
            return verb in ("create", "get")
        if verb in _READ_VERBS:
            return resource in _READ_OK or resource == "leases"
        if resource == "nodes":
            return verb in ("create", "update", "patch") and (
                not name or name == node_name
            )
        if resource == "leases":
            return verb in ("create", "update", "patch") and (
                not name or name == node_name
            )
        if resource == "pods":
            if verb == "create":
                return True  # mirror pods; NodeRestriction checks the body
            if verb in ("update", "patch", "delete"):
                return self._pod_bound_to(node_name, namespace, name)
            return False
        if resource == "bindings":
            return False  # binding is the scheduler's verb, never a kubelet's
        if resource == "events":
            return verb == "create"
        return False

    def authorize(self, user, verb, resource, namespace, name="") -> bool:
        if (
            user is not None
            and NODES_GROUP in getattr(user, "groups", ())
            and user.name.startswith(NODE_USER_PREFIX)
        ):
            node_name = user.name[len(NODE_USER_PREFIX):]
            return self._authorize_node(
                node_name, verb, resource, namespace or "", name
            )
        if self.rbac is None:
            return True
        return self.rbac.authorize(user, verb, resource, namespace, name)

    # delegate the RBAC-management surface so callers can keep using
    # authz.bind(...) unchanged
    def bind(self, subject, rule) -> None:
        self.rbac.bind(subject, rule)
