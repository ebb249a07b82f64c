"""Authentication, authorization, and admission for the API layer.

Reference shape (staging/src/k8s.io/apiserver/pkg/server/config.go:660,
DefaultBuildHandlerChain): requests pass authn → authz before reaching the
REST storage; write requests then run the ADMISSION chain (mutating plugins
first, then validating — apiserver/pkg/admission/chain.go) before
persisting. Here:

  * ``TokenAuthenticator`` — bearer-token table (the reference's
    --token-auth-file static tokens + ServiceAccount token secrets from the
    tokens controller);
  * ``RBACAuthorizer`` — RBAC-lite: rules (verbs × resources × namespaces)
    bound to users/groups, with ``system:masters`` always allowed
    (plugin/pkg/auth/authorizer/rbac);
  * ``AdmissionChain`` — ordered mutating → validating plugins, installed
    as a store admit hook so in-process clients and the HTTP façade pass
    through the same gate;
  * ``QuotaAdmission`` — the first real validating plugin: rejects pod
    creates that would exceed any ResourceQuota hard limit
    (plugin/pkg/admission/resourcequota).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..api import objects as v1
from ..api.resources import CPU, MEMORY, cpu_to_millis, to_int_value

logger = logging.getLogger("kubernetes_tpu.apiserver.auth")

ANONYMOUS = "system:anonymous"
MASTERS_GROUP = "system:masters"
ALL = "*"


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: Tuple[str, ...] = ()


class Forbidden(PermissionError):
    pass


class Unauthorized(PermissionError):
    pass


class AdmissionDenied(ValueError):
    pass


# ---------------------------------------------------------------------------
# authn
# ---------------------------------------------------------------------------


class TokenAuthenticator:
    """Static bearer tokens + ServiceAccount token secrets.

    ``authenticate`` returns a UserInfo, or None for requests with no
    credentials (the caller decides whether anonymous is allowed)."""

    def __init__(self, server=None, allow_anonymous: bool = True):
        self._tokens: Dict[str, UserInfo] = {}
        self._server = server  # for ServiceAccount token secret lookup
        self.allow_anonymous = allow_anonymous
        self._lock = threading.Lock()
        # SA-token index: rebuilt at most every _sa_ttl seconds, so the
        # authn hot path is an O(1) dict hit instead of a full secret list
        # + linear scan per request
        self._sa_index: Dict[str, UserInfo] = {}
        self._sa_built_at = float("-inf")
        self._sa_ttl = 2.0
        self._csr_index: Dict[str, UserInfo] = {}
        self._csr_built_at = float("-inf")

    def add_token(self, token: str, user: str, groups: Sequence[str] = ()) -> None:
        with self._lock:
            self._tokens[token] = UserInfo(user, tuple(groups))

    def _sa_tokens(self) -> Dict[str, UserInfo]:
        """ServiceAccount token index (tokens controller secrets): identity
        system:serviceaccount:<ns>:<name>."""
        import time

        now = time.monotonic()
        with self._lock:
            if now - self._sa_built_at < self._sa_ttl:
                return self._sa_index
        idx: Dict[str, UserInfo] = {}
        secrets, _ = self._server.list("secrets")
        for s in secrets:
            if s.type != "kubernetes.io/service-account-token":
                continue
            tok = s.data.get("token", b"")
            tok = tok.decode() if isinstance(tok, bytes) else str(tok)
            if not tok:
                continue
            sa = s.metadata.annotations.get(
                "kubernetes.io/service-account.name", "default"
            )
            idx[tok] = UserInfo(
                f"system:serviceaccount:{s.metadata.namespace}:{sa}",
                ("system:serviceaccounts",),
            )
        with self._lock:
            self._sa_index = idx
            self._sa_built_at = now
        return idx

    def _csr_tokens(self, force: bool = False) -> Dict[str, UserInfo]:
        """Signed-CSR credential index: the CSR signer issues an HMAC
        credential (controller/certificates.py CSRSigningController); a
        bearer presenting it authenticates as the CSR's username — the
        kubelet client-cert flow with tokens standing in for x509. Node
        usernames (system:node:*) get the system:nodes group, which routes
        them into the node authorizer (apiserver/nodeauth.py)."""
        import time

        now = time.monotonic()
        with self._lock:
            if not force and now - self._csr_built_at < self._sa_ttl:
                return self._csr_index
        try:
            csrs, _ = self._server.list("certificatesigningrequests")
        except Exception:
            # transient store failure: keep serving the stale index rather
            # than caching an empty one (which would 401 every node
            # credential for a TTL)
            logger.exception("rebuilding CSR token index failed; serving stale")
            with self._lock:
                self._csr_built_at = now
                return self._csr_index
        from .admission import NODE_USER_PREFIX, NODES_GROUP

        idx: Dict[str, UserInfo] = {}
        for c in csrs:
            cert = c.status.certificate
            if not cert:
                continue
            groups = tuple(c.spec.groups)
            if c.spec.username.startswith(NODE_USER_PREFIX):
                groups = tuple(sorted(set(groups) | {NODES_GROUP}))
            idx[cert] = UserInfo(c.spec.username, groups)
        with self._lock:
            self._csr_index = idx
            self._csr_built_at = now
        return idx

    def authenticate_token(self, token: str) -> Optional[UserInfo]:
        with self._lock:
            ui = self._tokens.get(token)
        if ui is not None:
            return ui
        if self._server is not None:
            ui = self._sa_tokens().get(token)
            if ui is not None:
                return ui
            ui = self._csr_tokens().get(token)
            if ui is None:
                # a freshly signed credential can be newer than the cached
                # index (a node joining within the TTL of the last rebuild
                # would be 401'd and its informer threads killed) — a miss
                # triggers one immediate rebuild before rejecting
                ui = self._csr_tokens(force=True).get(token)
            return ui
        return None

    def authenticate_header(self, authorization: str) -> Optional[UserInfo]:
        if not authorization:
            return None
        scheme, _, cred = authorization.partition(" ")
        if scheme.lower() != "bearer" or not cred:
            return None
        return self.authenticate_token(cred.strip())


# ---------------------------------------------------------------------------
# authz (RBAC-lite)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    verbs: FrozenSet[str]  # get/list/watch/create/update/delete or *
    resources: FrozenSet[str]  # resource names or *
    namespaces: FrozenSet[str] = frozenset({ALL})
    # specific object names (PolicyRule.resourceNames). A name-restricted
    # rule never matches unnamed requests (list/watch/create), matching
    # the reference's RuleAllows
    names: FrozenSet[str] = frozenset({ALL})

    def allows(
        self, verb: str, resource: str, namespace: str, name: str = ""
    ) -> bool:
        return (
            (ALL in self.verbs or verb in self.verbs)
            and (ALL in self.resources or resource in self.resources)
            and (ALL in self.namespaces or namespace in self.namespaces)
            and (ALL in self.names or (bool(name) and name in self.names))
        )


def make_rule(
    verbs: Sequence[str],
    resources: Sequence[str],
    namespaces: Sequence[str] = (ALL,),
    names: Sequence[str] = (ALL,),
) -> Rule:
    return Rule(
        frozenset(verbs),
        frozenset(resources),
        frozenset(namespaces),
        frozenset(names),
    )


# the verbs read-only roles get (rbac bootstrap "view")
READ_VERBS = ("get", "list", "watch")


class RBACAuthorizer:
    """Subject (user or group) → list of rules. ``system:masters`` is the
    reference's superuser group (rbac bootstrap cluster-admin binding).

    Two rule sources: programmatic ``bind`` calls (the bootstrap policy,
    plugin/pkg/auth/authorizer/rbac/bootstrappolicy) and — when built with
    a server — ClusterRole/ClusterRoleBinding API objects, rebuilt into a
    subject index on a short TTL like the SA-token index (the reference's
    RBAC authorizer resolves through informer caches)."""

    def __init__(self, server=None):
        self._subjects: Dict[str, List[Rule]] = {}
        self._lock = threading.Lock()
        self._server = server
        self._obj_index: Dict[str, List[Rule]] = {}
        self._obj_built_at = float("-inf")
        self._obj_ttl = 2.0

    def bind(self, subject: str, rule: Rule) -> None:
        with self._lock:
            self._subjects.setdefault(subject, []).append(rule)

    def _object_rules(self) -> Dict[str, List[Rule]]:
        import time

        now = time.monotonic()
        with self._lock:
            if now - self._obj_built_at < self._obj_ttl:
                return self._obj_index
        idx: Dict[str, List[Rule]] = {}
        try:
            roles = {
                r.metadata.name: r
                for r in self._server.list("clusterroles")[0]
            }
            for b in self._server.list("clusterrolebindings")[0]:
                role = roles.get(b.role_ref.name)
                if role is None:
                    continue
                rules = [
                    make_rule(
                        r.verbs,
                        r.resources,
                        names=r.resource_names or (ALL,),
                    )
                    for r in role.rules
                ]
                for s in b.subjects:
                    if s.kind == "ServiceAccount":
                        name = f"system:serviceaccount:{s.namespace}:{s.name}"
                    else:  # User and Group subjects are both plain keys
                        name = s.name
                    idx.setdefault(name, []).extend(rules)
        except Exception:
            # transient store failure: keep serving the stale index rather
            # than caching an empty one (which would 403 every
            # object-bound subject for a TTL); built_at still advances so
            # a broken store isn't hammered per request
            logger.exception(
                "rebuilding RBAC object index failed; serving stale index"
            )
            with self._lock:
                self._obj_built_at = now
                return self._obj_index
        with self._lock:
            self._obj_index = idx
            self._obj_built_at = now
        return idx

    def authorize(
        self,
        user: Optional[UserInfo],
        verb: str,
        resource: str,
        namespace: str,
        name: str = "",
    ) -> bool:
        if user is None:
            return False
        if MASTERS_GROUP in user.groups:
            return True
        with self._lock:
            rules = list(self._subjects.get(user.name, []))
            for g in user.groups:
                rules.extend(self._subjects.get(g, []))
        if self._server is not None:
            obj = self._object_rules()
            rules.extend(obj.get(user.name, []))
            for g in user.groups:
                rules.extend(obj.get(g, []))
        return any(r.allows(verb, resource, namespace, name) for r in rules)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


class AdmissionPlugin:
    """mutate() may modify obj in place; validate() raises AdmissionDenied."""

    name = "plugin"

    def mutate(self, verb: str, resource: str, obj) -> None:  # pragma: no cover
        pass

    def validate(self, verb: str, resource: str, obj) -> None:  # pragma: no cover
        pass


class AdmissionChain:
    """Ordered mutating phase, then validating phase (admission/chain.go:
    mutators run first so validators see final content). Installable as a
    store admit hook (APIServer.admit_hooks)."""

    def __init__(
        self,
        mutating: Sequence[AdmissionPlugin] = (),
        validating: Sequence[AdmissionPlugin] = (),
    ):
        self.mutating = list(mutating)
        self.validating = list(validating)

    def __call__(self, verb: str, resource: str, obj) -> None:
        for p in self.mutating:
            p.mutate(verb, resource, obj)
        for p in self.validating:
            p.validate(verb, resource, obj)


class QuotaAdmission(AdmissionPlugin):
    """Deny pod creates that would exceed any ResourceQuota hard limit in
    the namespace (plugin/pkg/admission/resourcequota). Check-and-reserve:
    usage is recomputed live and racing creates serialize through the
    plugin's own mutex, with an in-flight reservation ledger covering the
    window between a create passing admission and its pod appearing in the
    store — mirroring the reference's transactional quota reservation
    (racing creates cannot both pass a quota with room for one).
    Reservations clear as soon as the pod is visible, or after a short TTL
    when the create failed downstream of admission."""

    name = "ResourceQuota"

    def __init__(self, server, reserve_ttl_s: float = 5.0):
        self.server = server
        self._lock = threading.Lock()
        self._ttl = reserve_ttl_s
        self._reserved: dict = {}  # ns -> {pod_key: (delta, deadline)}

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        ns = obj.metadata.namespace
        quotas, _ = self.server.list("resourcequotas", namespace=ns)
        if not quotas:
            return
        from ..controller.resourcequota import compute_namespace_usage

        req = v1.compute_pod_resource_request(obj)
        delta = {
            "pods": 1,
            "requests.cpu": int(req.get(CPU, 0)),
            "cpu": int(req.get(CPU, 0)),
            "requests.memory": int(req.get(MEMORY, 0)),
            "memory": int(req.get(MEMORY, 0)),
        }
        from .admission import pod_matches_scopes

        with self._lock:
            # purge BEFORE computing usage: the other order can drop a
            # reservation whose pod landed between the usage read and the
            # purge, leaving it counted nowhere (review r4). This order can
            # only double-count (reservation kept + pod already in usage) —
            # a transient fail-closed, never an over-admission.
            now = time.monotonic()
            res = self._reserved.setdefault(ns, {})
            for key in list(res):
                _d, deadline, _rpod = res[key]
                # the pod landed (usage counts it now) or the create died
                # downstream of admission (TTL): drop the reservation
                if deadline < now or self._pod_exists(key):
                    del res[key]
            usage_by_scopes: dict = {}  # scopes tuple -> usage incl. reserved
            matched_any = False
            for q in quotas:
                scopes = tuple(q.spec.scopes)
                # a scoped quota constrains only matching pods
                if scopes and not pod_matches_scopes(obj, scopes):
                    continue
                matched_any = True
                usage = usage_by_scopes.get(scopes)
                if usage is None:
                    usage = compute_namespace_usage(self.server, ns, scopes)
                    for entry in res.values():
                        d, _deadline, rpod = entry
                        # a reservation counts toward this quota only if
                        # ITS pod matches the quota's scopes too
                        if scopes and not pod_matches_scopes(rpod, scopes):
                            continue
                        for rn, v in d.items():
                            usage[rn] = usage.get(rn, 0) + v
                    usage_by_scopes[scopes] = usage
                for res_name, hard in q.spec.hard.items():
                    # hard limits are k8s quantities ("2", "500m", "4Gi");
                    # usage is millicores/bytes/counts — same-unit parse
                    if "cpu" in res_name:
                        limit = cpu_to_millis(hard)
                    else:
                        limit = to_int_value(hard)
                    want = usage.get(res_name, 0) + delta.get(res_name, 0)
                    if want > limit:
                        raise AdmissionDenied(
                            f"exceeded quota {q.metadata.name}: requested "
                            f"{res_name}={delta.get(res_name, 0)}, used "
                            f"{usage.get(res_name, 0)}, limited {hard}"
                        )
            if matched_any:
                res[obj.metadata.key] = (delta, now + self._ttl, obj)

    def _pod_exists(self, key: str) -> bool:
        try:
            return self.server.exists("pods", key)
        except Exception:
            return False


class NamespaceLifecycleAdmission(AdmissionPlugin):
    """Reject creates in terminating or nonexistent namespaces
    (plugin/pkg/admission/namespace/lifecycle). System namespaces
    (default, kube-system) are implicit."""

    name = "NamespaceLifecycle"

    IMPLICIT = {"default", "kube-system", "kube-public", ""}
    CLUSTER_SCOPED = {"namespaces"}

    def __init__(self, server):
        self.server = server

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource in self.CLUSTER_SCOPED:
            return
        ns = obj.metadata.namespace
        if ns in self.IMPLICIT:
            return
        try:
            ns_obj = self.server.get("namespaces", "default", ns)
        except KeyError:
            try:
                ns_obj = self.server.get("namespaces", "", ns)
            except KeyError:
                raise AdmissionDenied(f"namespace {ns!r} not found") from None
        if ns_obj.metadata.deletion_timestamp is not None:
            raise AdmissionDenied(
                f"namespace {ns!r} is terminating: no new objects"
            )


class LimitRangerAdmission(AdmissionPlugin):
    """Apply LimitRange defaults and enforce min/max on pod containers
    (plugin/pkg/admission/limitranger): containers without requests get the
    range's defaultRequest; requests outside [min, max] are denied."""

    name = "LimitRanger"

    def __init__(self, server):
        self.server = server

    def _ranges(self, ns: str):
        # fail-CLOSED: an enforcement gate that cannot read its policy must
        # deny, not wave pods through — list errors propagate to the caller
        items, _ = self.server.list("limitranges", namespace=ns)
        return [
            item
            for lr in items
            for item in lr.spec.limits
            if item.type == "Container"
        ]

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        for item in self._ranges(obj.metadata.namespace):
            for c in obj.spec.containers:
                for res_name, q in item.default_request.items():
                    c.requests.setdefault(res_name, q)
                for res_name, q in item.default.items():
                    c.limits.setdefault(res_name, q)

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        from ..api.resources import cpu_to_millis, to_int_value

        def units(res_name, q):
            return cpu_to_millis(q) if "cpu" in res_name else to_int_value(q)

        for item in self._ranges(obj.metadata.namespace):
            for c in obj.spec.containers:
                for res_name, lo in item.min.items():
                    have = c.requests.get(res_name)
                    # absent request FAILS min (the reference denies when no
                    # value is specified against a min constraint — the
                    # mutating pass already applied any defaultRequest)
                    if have is None or units(res_name, have) < units(
                        res_name, lo
                    ):
                        raise AdmissionDenied(
                            f"minimum {res_name} usage per Container is {lo}"
                        )
                for res_name, hi in item.max.items():
                    # max binds requests AND limits: either exceeding it is
                    # a denial (limitranger checks both value classes)
                    for have in (c.requests.get(res_name), c.limits.get(res_name)):
                        if have is not None and units(res_name, have) > units(
                            res_name, hi
                        ):
                            raise AdmissionDenied(
                                f"maximum {res_name} usage per Container is {hi}"
                            )


class PriorityAdmission(AdmissionPlugin):
    """Resolve pod spec.priority_class_name -> spec.priority at create
    (plugin/pkg/admission/priority/admission.go): named class sets the
    value, a globalDefault class covers unnamed pods, and an unknown class
    name is rejected."""

    name = "Priority"

    def __init__(self, server):
        self.server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        if obj.spec.priority is not None and not obj.spec.priority_class_name:
            return
        classes, _ = self.server.list("priorityclasses")
        if obj.spec.priority_class_name:
            pc = next(
                (
                    c
                    for c in classes
                    if c.metadata.name == obj.spec.priority_class_name
                ),
                None,
            )
            if pc is None:
                raise AdmissionDenied(
                    f"no PriorityClass {obj.spec.priority_class_name!r}"
                )
            obj.spec.priority = pc.value
            if obj.spec.preemption_policy is None:
                obj.spec.preemption_policy = pc.preemption_policy
            elif obj.spec.preemption_policy != pc.preemption_policy:
                # admission.go rejects the mismatch: a pod must not claim a
                # class's priority while discarding its preemption policy
                raise AdmissionDenied(
                    f"pod preemptionPolicy {obj.spec.preemption_policy!r} "
                    f"conflicts with PriorityClass "
                    f"{pc.metadata.name!r} policy {pc.preemption_policy!r}"
                )
            return
        default = next((c for c in classes if c.global_default), None)
        if default is not None and obj.spec.priority is None:
            obj.spec.priority = default.value
            obj.spec.priority_class_name = default.metadata.name
            if obj.spec.preemption_policy is None:
                obj.spec.preemption_policy = default.preemption_policy
            elif obj.spec.preemption_policy != default.preemption_policy:
                # same mismatch rule as the named-class branch: the
                # resolved class's policy binds
                raise AdmissionDenied(
                    f"pod preemptionPolicy {obj.spec.preemption_policy!r} "
                    f"conflicts with default PriorityClass "
                    f"{default.metadata.name!r} policy "
                    f"{default.preemption_policy!r}"
                )


class DefaultStorageClassAdmission(AdmissionPlugin):
    """PVCs created without a class get the cluster default
    (plugin/pkg/admission/storage/storageclass/setdefault): the
    StorageClass annotated storageclass.kubernetes.io/is-default-class."""

    name = "DefaultStorageClass"
    DEFAULT_ANNOTATION = "storageclass.kubernetes.io/is-default-class"

    def __init__(self, server):
        self.server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "persistentvolumeclaims":
            return
        if obj.spec.storage_class_name is not None:
            return  # explicit class (or explicit "" = no dynamic provision)
        for sc in self.server.list("storageclasses")[0]:
            if (
                sc.metadata.annotations.get(self.DEFAULT_ANNOTATION, "").lower()
                == "true"
            ):
                obj.spec.storage_class_name = sc.metadata.name
                return


TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"


class DefaultTolerationSecondsAdmission(AdmissionPlugin):
    """Every pod tolerates not-ready/unreachable NoExecute taints for a
    bounded window (plugin/pkg/admission/defaulttolerationseconds): node
    failure doesn't instantly evict, but eviction isn't disabled either —
    the nodelifecycle evictor honors tolerationSeconds."""

    name = "DefaultTolerationSeconds"

    def __init__(self, toleration_seconds: int = 300):
        self.toleration_seconds = toleration_seconds

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        for key in (TAINT_NOT_READY, TAINT_UNREACHABLE):
            # Toleration.tolerates covers the wildcard key=""+Exists form:
            # a tolerate-everything pod must NOT get a bounded override
            taint = v1.Taint(key, "", v1.TAINT_NO_EXECUTE)
            if any(t.tolerates(taint) for t in obj.spec.tolerations):
                continue
            obj.spec.tolerations.append(
                v1.Toleration(
                    key=key,
                    operator=v1.TOLERATION_OP_EXISTS,
                    effect=v1.TAINT_NO_EXECUTE,
                    toleration_seconds=self.toleration_seconds,
                )
            )


class ServiceAccountAdmission(AdmissionPlugin):
    """Default pod spec.service_account to "default" (the mutating half of
    plugin/pkg/admission/serviceaccount, minus volume injection)."""

    name = "ServiceAccount"

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        if hasattr(obj.spec, "service_account_name") and not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"
