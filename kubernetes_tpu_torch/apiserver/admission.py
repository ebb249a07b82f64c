"""Admission breadth: NodeRestriction, AlwaysPullImages, PodSecurityPolicy,
and quota scope selection.

Reference: plugin/pkg/admission/noderestriction/admission.go (node
identities may mutate only their own Node and pods bound to them),
…/alwayspullimages (force PullAlways so a scheduled-together pod can't read
a private image from the node cache), …/security/podsecuritypolicy
(validate pod security posture against cluster policies), and the quota
evaluator's scope matching (pkg/quota/v1/evaluator/core/pods.go
podMatchesScopeFunc).

The requesting identity reaches in-process admission through a contextvar
the REST layer sets after authentication — the moral equivalent of
admission.Attributes.GetUserInfo(). In-process callers (controllers,
tests) have no identity set and are unrestricted, like loopback clients
with cluster-admin.
"""

from __future__ import annotations

import contextvars
from typing import Optional

from ..api import objects as v1
from .auth import AdmissionDenied, AdmissionPlugin

# set by the REST layer per request (None = loopback/in-process client)
request_user: contextvars.ContextVar = contextvars.ContextVar(
    "request_user", default=None
)

NODE_USER_PREFIX = "system:node:"
NODES_GROUP = "system:nodes"


class NodeRestrictionAdmission(AdmissionPlugin):
    """A node identity (user system:node:<name>, group system:nodes) may
    mutate only its OWN Node object and pods BOUND to it (the mirror-pod /
    status-update surface). Everything else is denied — a compromised
    kubelet cannot reach across the cluster."""

    name = "NodeRestriction"

    def validate(self, verb: str, resource: str, obj) -> None:
        user = request_user.get()
        if user is None or NODES_GROUP not in getattr(user, "groups", ()):
            return
        if not user.name.startswith(NODE_USER_PREFIX):
            raise AdmissionDenied(
                f"user in {NODES_GROUP} without a node identity: {user.name}"
            )
        node_name = user.name[len(NODE_USER_PREFIX):]
        if resource == "nodes":
            if obj is not None and obj.metadata.name != node_name:
                raise AdmissionDenied(
                    f"node {node_name!r} cannot modify node "
                    f"{obj.metadata.name!r}"
                )
            return
        if resource == "pods":
            bound = getattr(obj.spec, "node_name", "") if obj is not None else ""
            if bound != node_name:
                raise AdmissionDenied(
                    f"node {node_name!r} can only {verb} pods bound to "
                    f"itself (pod bound to {bound or 'nothing'})"
                )
            return
        if resource == "leases":
            # node heartbeat leases: only its own
            if obj is not None and obj.metadata.name != node_name:
                raise AdmissionDenied(
                    f"node {node_name!r} cannot renew lease "
                    f"{obj.metadata.name!r}"
                )
            return
        raise AdmissionDenied(
            f"node identity may not {verb} {resource} objects"
        )


class AlwaysPullImagesAdmission(AdmissionPlugin):
    """Force imagePullPolicy=Always on every container at create: without
    it, any pod scheduled onto a node can run a private image already
    pulled there without presenting credentials."""

    name = "AlwaysPullImages"

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            c.image_pull_policy = "Always"


class PodSecurityPolicyAdmission(AdmissionPlugin):
    """Validate pod security posture against the cluster's
    PodSecurityPolicy objects: the pod is admitted iff SOME policy allows
    every requested capability (privileged, hostNetwork, run-as-user).
    No policies installed = the gate is open (the plugin disabled state;
    the reference denies, but requires explicit enablement — here
    installing the first policy arms the gate)."""

    name = "PodSecurityPolicy"

    def __init__(self, server):
        self.server = server

    @staticmethod
    def _pod_wants(pod) -> dict:
        privileged = any(
            c.security_context is not None and c.security_context.privileged
            for c in list(pod.spec.containers) + list(pod.spec.init_containers)
        )
        runs_as_root = any(
            c.security_context is not None
            and c.security_context.run_as_user == 0
            for c in list(pod.spec.containers) + list(pod.spec.init_containers)
        )
        return {
            "privileged": privileged,
            "host_network": pod.spec.host_network,
            "runs_as_root": runs_as_root,
        }

    @staticmethod
    def _allows(psp: "v1.PodSecurityPolicy", wants: dict) -> Optional[str]:
        s = psp.spec
        if wants["privileged"] and not s.privileged:
            return "privileged containers are not allowed"
        if wants["host_network"] and not s.host_network:
            return "hostNetwork is not allowed"
        if s.run_as_user_rule == "MustRunAsNonRoot" and wants["runs_as_root"]:
            return "running as root (runAsUser=0) is not allowed"
        return None

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        try:
            policies, _ = self.server.list("podsecuritypolicies")
        except Exception:
            return
        if not policies:
            return
        wants = self._pod_wants(obj)
        reasons = []
        for psp in sorted(policies, key=lambda p: p.metadata.name):
            why = self._allows(psp, wants)
            if why is None:
                return  # some policy admits the pod
            reasons.append(f"{psp.metadata.name}: {why}")
        raise AdmissionDenied(
            "unable to validate against any pod security policy: "
            + "; ".join(reasons)
        )


class ExtendedResourceTolerationAdmission(AdmissionPlugin):
    """Pods requesting extended resources get tolerations for taints keyed
    by those resources (plugin/pkg/admission/extendedresourcetoleration):
    the TPU-shaped flow — nodes carrying tpu.dev/chip advertise a matching
    NoSchedule taint so ordinary pods stay off the accelerator pool, and
    chip-requesting pods tolerate it automatically."""

    name = "ExtendedResourceToleration"

    BUILTIN = frozenset({"cpu", "memory", "ephemeral-storage", "pods"})

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        wanted = set()
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            for name in list(c.requests) + list(c.limits):
                if "/" in name and name not in self.BUILTIN:
                    wanted.add(name)
        for res_name in sorted(wanted):
            taint = v1.Taint(res_name, "", v1.TAINT_NO_SCHEDULE)
            # effect/operator-aware: a key-matching toleration with the
            # wrong effect would NOT tolerate the pool's NoSchedule taint
            if any(t.tolerates(taint) for t in obj.spec.tolerations):
                continue
            obj.spec.tolerations.append(
                v1.Toleration(
                    key=res_name, operator="Exists", effect="NoSchedule"
                )
            )


class PodNodeSelectorAdmission(AdmissionPlugin):
    """Namespace-pinned node selectors (plugin/pkg/admission/podnodeselector):
    the namespace's scheduler.alpha.kubernetes.io/node-selector annotation
    merges into every pod created there; conflicts are denied."""

    name = "PodNodeSelector"
    ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"

    def __init__(self, server):
        self.server = server

    def _ns_selector(self, namespace: str) -> dict:
        try:
            ns = self.server.get("namespaces", "", namespace)
        except Exception:
            return {}
        raw = ns.metadata.annotations.get(self.ANNOTATION, "")
        out = {}
        for part in raw.split(","):
            if "=" in part:
                k, _, val = part.partition("=")
                out[k.strip()] = val.strip()
        return out

    def mutate(self, verb: str, resource: str, obj) -> None:
        # create merges the pin; update re-verifies it (a PUT rewriting the
        # selector must not escape the namespace pin before scheduling)
        if verb not in ("create", "update") or resource != "pods":
            return
        sel = self._ns_selector(obj.metadata.namespace)
        for k, val in sel.items():
            if obj.spec.node_selector.get(k, val) != val:
                raise AdmissionDenied(
                    f"pod node selector {k}={obj.spec.node_selector[k]} "
                    f"conflicts with namespace selector {k}={val}"
                )
            obj.spec.node_selector[k] = val


class PodTolerationRestrictionAdmission(AdmissionPlugin):
    """Namespace toleration whitelists (plugin/pkg/admission/
    podtolerationrestriction): a pod may only carry tolerations the
    namespace's whitelist annotation allows (JSON list of Toleration
    objects, reference admission.go:59 NSWLTolerations; no annotation =
    everything allowed).

    Chain position follows AllOrderedPlugins (plugins.go:83): AFTER
    DefaultTolerationSeconds — whose injected not-ready/unreachable
    tolerations are therefore whitelist-checked, exactly like the
    reference's merged-set verification (VerifyAgainstWhitelist over
    pod.Spec.Tolerations post-merge) — and BEFORE
    ExtendedResourceToleration, whose additions escape the check. On
    update, only NEWLY ADDED toleration keys are checked (the stored pod
    legitimately carries chain-injected keys from create)."""

    name = "PodTolerationRestriction"
    # the reference's NSWLTolerations annotation key (admission.go:59); the
    # value is a JSON list of full Toleration objects
    WHITELIST = "scheduler.alpha.kubernetes.io/tolerationsWhitelist"

    def __init__(self, server):
        self.server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb not in ("create", "update") or resource != "pods":
            return
        import json as _json

        try:
            ns = self.server.get("namespaces", "", obj.metadata.namespace)
        except Exception:
            return
        raw = ns.metadata.annotations.get(self.WHITELIST, "")
        if not raw:
            return
        try:
            # reference wire format: a list of Toleration objects; the
            # key is the whitelist axis this build enforces
            allowed = {e.get("key", "") for e in _json.loads(raw)}
        except (ValueError, AttributeError):
            return  # malformed whitelist: fail open like a missing one
        exempt: set = set()
        if verb == "update":
            try:
                cur = self.server.get(
                    "pods", obj.metadata.namespace, obj.metadata.name
                )
                exempt = {t.key for t in cur.spec.tolerations}
            except Exception:
                pass
        for t in obj.spec.tolerations:
            if t.key not in allowed and t.key not in exempt:
                raise AdmissionDenied(
                    f"toleration {t.key!r} is not whitelisted in namespace "
                    f"{obj.metadata.namespace}"
                )


class PVCResizeAdmission(AdmissionPlugin):
    """PVC expansion gate (plugin/pkg/admission/storage/
    persistentvolumeclaimresize): size may only GROW, and only when the
    claim's StorageClass allows expansion."""

    name = "PersistentVolumeClaimResize"

    def __init__(self, server):
        self.server = server

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "update" or resource != "persistentvolumeclaims":
            return
        from ..api.resources import parse_quantity

        try:
            cur = self.server.get(
                "persistentvolumeclaims",
                obj.metadata.namespace,
                obj.metadata.name,
            )
        except Exception:
            return
        old_size = parse_quantity(cur.spec.resources.get("storage", 0))
        new_size = parse_quantity(obj.spec.resources.get("storage", 0))
        if new_size == old_size:
            return
        if new_size < old_size:
            raise AdmissionDenied("persistent volume claims may not shrink")
        # the BOUND class decides (the incoming object could swap in an
        # expandable class in the same update to dodge the gate; nothing
        # else enforces storage-class immutability here)
        sc_name = cur.spec.storage_class_name
        if not sc_name:
            raise AdmissionDenied(
                "only claims with an expandable StorageClass may be resized"
            )
        try:
            sc = self.server.get("storageclasses", "", sc_name)
        except Exception:
            raise AdmissionDenied(f"storage class {sc_name!r} not found")
        if not sc.allow_volume_expansion:
            raise AdmissionDenied(
                f"storage class {sc_name!r} does not allow volume expansion"
            )


class RuntimeClassAdmission(AdmissionPlugin):
    """Merge a pod's named RuntimeClass into its spec at create
    (plugin/pkg/admission/runtimeclass/admission.go): the class's overhead
    becomes spec.overhead (a user-supplied CONFLICTING overhead is denied),
    and the class's scheduling nodeSelector/tolerations merge like
    PodNodeSelector does — selector conflicts are denied, tolerations
    append."""

    name = "RuntimeClass"

    def __init__(self, server):
        self.server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "pods":
            return
        rc_name = obj.spec.runtime_class_name
        if not rc_name:
            return
        try:
            # cluster-scoped: the store canonicalizes the namespace to ""
            rc = self.server.get("runtimeclasses", "", rc_name)
        except Exception:
            raise AdmissionDenied(
                f"pod rejected: RuntimeClass {rc_name!r} not found"
            )
        if rc.overhead:
            if obj.spec.overhead and dict(obj.spec.overhead) != dict(rc.overhead):
                raise AdmissionDenied(
                    "pod overhead does not match RuntimeClass "
                    f"{rc_name!r} overhead"
                )
            obj.spec.overhead = dict(rc.overhead)
        sched = rc.scheduling
        if sched is not None:
            for k, val in sched.node_selector.items():
                if obj.spec.node_selector.get(k, val) != val:
                    raise AdmissionDenied(
                        f"pod node selector {k}={obj.spec.node_selector[k]} "
                        f"conflicts with RuntimeClass selector {k}={val}"
                    )
                obj.spec.node_selector[k] = val
            existing = {
                (t.key, t.operator, t.value, t.effect)
                for t in obj.spec.tolerations
            }
            for t in sched.tolerations:
                if (t.key, t.operator, t.value, t.effect) not in existing:
                    obj.spec.tolerations.append(t)


class TaintNodesByConditionAdmission(AdmissionPlugin):
    """New nodes are tainted not-ready at create
    (plugin/pkg/admission/nodetaint/admission.go): the node lifecycle
    controller lifts the taint once the node reports Ready, closing the
    window where pods land on a node whose kubelet has not yet synced."""

    name = "TaintNodesByCondition"
    TAINT_KEY = "node.kubernetes.io/not-ready"

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "nodes":
            return
        # a registration that already reports Ready=True has no
        # kubelet-not-yet-synced window to close (this build's kubelet
        # registers with live status in one write; the reference's
        # two-step register-then-sync is where the window exists)
        if any(
            c.type == v1.NODE_READY and c.status == "True"
            for c in obj.status.conditions
        ):
            return
        if any(t.key == self.TAINT_KEY for t in obj.spec.taints):
            return
        obj.spec.taints.append(
            v1.Taint(self.TAINT_KEY, "", v1.TAINT_NO_SCHEDULE)
        )


class StorageObjectInUseProtectionAdmission(AdmissionPlugin):
    """PVCs/PVs get their protection finalizer at create
    (plugin/pkg/admission/storage/storageobjectinuseprotection): deletion
    then parks until the protection controller confirms no pod uses the
    object (controller/podgc.py PVC/PVProtectionController strips it)."""

    name = "StorageObjectInUseProtection"
    PVC_FINALIZER = "kubernetes.io/pvc-protection"
    PV_FINALIZER = "kubernetes.io/pv-protection"

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create":
            return
        if resource == "persistentvolumeclaims":
            if self.PVC_FINALIZER not in obj.metadata.finalizers:
                obj.metadata.finalizers.append(self.PVC_FINALIZER)
        elif resource == "persistentvolumes":
            if self.PV_FINALIZER not in obj.metadata.finalizers:
                obj.metadata.finalizers.append(self.PV_FINALIZER)


class CertificateSubjectRestrictionAdmission(AdmissionPlugin):
    """CSRs for the kube-apiserver-client signer claiming system:masters
    are denied (plugin/pkg/admission/certificates/subjectrestriction):
    auto-approval flows must never be able to mint a cluster-admin
    credential."""

    name = "CertificateSubjectRestriction"
    SIGNER = "kubernetes.io/kube-apiserver-client"
    BLOCKED_GROUP = "system:masters"

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "certificatesigningrequests":
            return
        if (
            obj.spec.signer_name == self.SIGNER
            and self.BLOCKED_GROUP in obj.spec.groups
        ):
            raise AdmissionDenied(
                f"use of signer {self.SIGNER} is not allowed for group "
                f"{self.BLOCKED_GROUP}"
            )


def pod_matches_scopes(pod, scopes) -> bool:
    """Quota scope selection (podMatchesScopeFunc): a scoped quota tracks
    and limits only matching pods. BestEffort = no container requests or
    limits at all; Terminating = activeDeadlineSeconds set."""
    for scope in scopes:
        best_effort = not any(
            c.requests or c.limits
            for c in list(pod.spec.containers) + list(pod.spec.init_containers)
        )
        terminating = pod.spec.active_deadline_seconds is not None
        if scope == "BestEffort" and not best_effort:
            return False
        if scope == "NotBestEffort" and best_effort:
            return False
        if scope == "Terminating" and not terminating:
            return False
        if scope == "NotTerminating" and terminating:
            return False
    return True


class NamespaceAutoProvisionAdmission(AdmissionPlugin):
    """Create the namespace on first use (plugin/pkg/admission/namespace/
    autoprovision/admission.go): a namespaced create whose namespace does
    not exist provisions it instead of failing. Default-off in the
    reference's recommended set, like here."""

    name = "NamespaceAutoProvision"

    def __init__(self, server):
        self._server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource in ("namespaces", "events"):
            return
        from ..api.serialization import CLUSTER_SCOPED

        if resource in CLUSTER_SCOPED:
            return
        ns = getattr(obj.metadata, "namespace", "")
        if not ns:
            return
        from ..client.apiserver import AlreadyExists, NotFound

        try:
            self._server.get("namespaces", "", ns)
        except NotFound:
            try:
                self._server.create(
                    "namespaces",
                    v1.Namespace(metadata=v1.ObjectMeta(name=ns, namespace="")),
                )
            except AlreadyExists:
                pass


class NamespaceExistsAdmission(AdmissionPlugin):
    """Reject namespaced creates into a namespace that does not exist
    (plugin/pkg/admission/namespace/exists/admission.go)."""

    name = "NamespaceExists"

    def __init__(self, server):
        self._server = server

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource in ("namespaces", "events"):
            return
        from ..api.serialization import CLUSTER_SCOPED

        if resource in CLUSTER_SCOPED:
            return
        ns = getattr(obj.metadata, "namespace", "")
        if not ns:
            return
        from ..client.apiserver import NotFound

        try:
            self._server.get("namespaces", "", ns)
        except NotFound:
            raise AdmissionDenied(f"namespace {ns!r} does not exist")


class SecurityContextDenyAdmission(AdmissionPlugin):
    """Deny pods that customize the security-sensitive SecurityContext
    fields (plugin/pkg/admission/securitycontext/scdeny/admission.go —
    the pre-PSP hard gate). Default-off, for clusters without PSP."""

    name = "SecurityContextDeny"

    def validate(self, verb: str, resource: str, obj) -> None:
        if resource != "pods" or verb not in ("create", "update"):
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            sc = c.security_context
            if sc is None:
                continue
            if sc.privileged or sc.run_as_user is not None:
                raise AdmissionDenied(
                    "SecurityContextDeny: securityContext.privileged and "
                    "runAsUser are forbidden"
                )


class LimitPodHardAntiAffinityTopologyAdmission(AdmissionPlugin):
    """Deny required pod anti-affinity with a topology key other than
    kubernetes.io/hostname (plugin/pkg/admission/antiaffinity): a
    zone-wide REQUIRED anti-affinity term lets one tenant fence whole
    failure domains from everyone else."""

    name = "LimitPodHardAntiAffinityTopology"
    HOSTNAME = "kubernetes.io/hostname"

    def validate(self, verb: str, resource: str, obj) -> None:
        if resource != "pods" or verb not in ("create", "update"):
            return
        aff = obj.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            return
        for term in aff.pod_anti_affinity.required:
            if term.topology_key != self.HOSTNAME:
                raise AdmissionDenied(
                    "affinity.podAntiAffinity.requiredDuringScheduling... "
                    f"topologyKey must be {self.HOSTNAME} "
                    f"(got {term.topology_key!r})"
                )


class EventRateLimitAdmission(AdmissionPlugin):
    """Server-scope token bucket over event writes (plugin/pkg/admission/
    eventratelimit): an event storm (crash-looping workload, hot failure
    path) must not starve the API server for every other client. Over
    budget => deny (the recorder treats event writes as best-effort and
    drops). Default-off, like the reference."""

    name = "EventRateLimit"

    def __init__(self, qps: float = 50.0, burst: int = 100):
        import threading
        import time as _time

        self._qps = float(qps)
        self._burst = float(burst)
        self._tokens = float(burst)
        self._t_last = _time.monotonic()
        self._mu = threading.Lock()

    def validate(self, verb: str, resource: str, obj) -> None:
        if resource != "events" or verb not in ("create", "update"):
            return
        import time as _time

        with self._mu:
            now = _time.monotonic()
            self._tokens = min(
                self._burst, self._tokens + (now - self._t_last) * self._qps
            )
            self._t_last = now
            if self._tokens < 1.0:
                raise AdmissionDenied(
                    "EventRateLimit: server event budget exhausted"
                )
            self._tokens -= 1.0


class OwnerReferencesPermissionEnforcementAdmission(AdmissionPlugin):
    """Setting ownerReferences[].blockOwnerDeletion makes the GC hold the
    OWNER's deletion until this dependent is gone — so it requires
    delete (finalizer-grade) permission on that owner (plugin/pkg/
    admission/gc/gc_admission.go). Gates the DELTA like the reference:
    only refs NEWLY gaining the bit are checked, so an unrelated update
    (label patch) by a user without owner-delete permission still lands
    on an already-protected object. In-process callers (no request user)
    are unrestricted, like loopback cluster-admin."""

    name = "OwnerReferencesPermissionEnforcement"

    def __init__(self, authorizer, server=None):
        self._authz = authorizer
        self._server = server

    def _blocking(self, obj) -> dict:
        return {
            (r.kind, r.name): r
            for r in (getattr(obj.metadata, "owner_references", None) or [])
            if getattr(r, "block_owner_deletion", False)
        }

    def validate(self, verb: str, resource: str, obj) -> None:
        if verb not in ("create", "update"):
            return
        user = request_user.get()
        if user is None:
            return
        new_blocking = self._blocking(obj)
        if not new_blocking:
            return
        if verb == "update" and self._server is not None:
            from ..client.apiserver import NotFound

            try:
                old = self._server.get(
                    resource, obj.metadata.namespace, obj.metadata.name
                )
                for key in self._blocking(old):
                    new_blocking.pop(key, None)  # already protected
            except NotFound:
                pass
        from ..api.serialization import KIND_TO_RESOURCE

        for (kind, name), ref in new_blocking.items():
            owner_res = KIND_TO_RESOURCE.get(kind, kind.lower() + "s")
            if not self._authz.authorize(
                user, "delete", owner_res, obj.metadata.namespace, name
            ):
                raise AdmissionDenied(
                    f"cannot set blockOwnerDeletion on {kind} "
                    f"{name!r}: user {user.name!r} may not delete it"
                )


class DefaultIngressClassAdmission(AdmissionPlugin):
    """Stamp the cluster-default IngressClass onto classless Ingresses at
    create (plugin/pkg/admission/defaultingressclass — the 1.18
    networking analogue of DefaultStorageClass). Multiple defaults =>
    deny, like the reference."""

    name = "DefaultIngressClass"
    DEFAULT_ANN = "ingressclass.kubernetes.io/is-default-class"

    def __init__(self, server):
        self._server = server

    def mutate(self, verb: str, resource: str, obj) -> None:
        if verb != "create" or resource != "ingresses":
            return
        if obj.spec.ingress_class_name is not None:
            return
        defaults = [
            ic
            for ic in self._server.list("ingressclasses")[0]
            if ic.metadata.annotations.get(self.DEFAULT_ANN) == "true"
        ]
        if not defaults:
            return
        if len(defaults) > 1:
            raise AdmissionDenied(
                "multiple default IngressClasses marked: "
                + ", ".join(sorted(ic.metadata.name for ic in defaults))
            )
        obj.spec.ingress_class_name = defaults[0].metadata.name


class CertificateApprovalAdmission(AdmissionPlugin):
    """Approving a CSR requires 'approve' permission on the signer
    (plugin/pkg/admission/certificates/approval): RBAC gates WHO may
    bless requests for WHICH signerName. Gates the DELTA like the
    reference (only updates that CHANGE the approval conditions) — a
    signer identity writing status.certificate on an already-approved
    CSR must not need 'approve' — and ALSO gates create: a CSR born
    with an Approved condition would otherwise bypass the gate entirely
    and mint a live credential via the CSR token index."""

    name = "CertificateApproval"

    def __init__(self, authorizer, server=None):
        self._authz = authorizer
        self._server = server

    @staticmethod
    def _approval_state(obj) -> tuple:
        return tuple(
            sorted(
                (c.type, c.status)
                for c in obj.status.conditions
                if c.type in ("Approved", "Denied")
            )
        )

    def validate(self, verb: str, resource: str, obj) -> None:
        if resource != "certificatesigningrequests" or verb not in (
            "create", "update",
        ):
            return
        user = request_user.get()
        if user is None:
            return
        new_state = self._approval_state(obj)
        if not new_state:
            return
        if verb == "update" and self._server is not None:
            from ..client.apiserver import NotFound

            try:
                old = self._server.get(resource, "", obj.metadata.name)
                if self._approval_state(old) == new_state:
                    return  # approval unchanged: not an approval write
            except NotFound:
                pass
        if not self._authz.authorize(
            user, "approve", "signers", "", obj.spec.signer_name
        ):
            raise AdmissionDenied(
                f"user {user.name!r} may not approve requests for signer "
                f"{obj.spec.signer_name!r}"
            )


class CertificateSigningAdmission(AdmissionPlugin):
    """Issuing the certificate (writing status.certificate) requires
    'sign' permission on the signer (plugin/pkg/admission/certificates/
    signing). Delta-gated like approval, and create-gated for the same
    reason: a CSR created WITH a certificate would otherwise inject a
    live credential without anyone holding 'sign'."""

    name = "CertificateSigning"

    def __init__(self, authorizer, server=None):
        self._authz = authorizer
        self._server = server

    def validate(self, verb: str, resource: str, obj) -> None:
        if resource != "certificatesigningrequests" or verb not in (
            "create", "update",
        ):
            return
        user = request_user.get()
        if user is None:
            return
        if not obj.status.certificate:
            return
        if verb == "update" and self._server is not None:
            from ..client.apiserver import NotFound

            try:
                old = self._server.get(resource, "", obj.metadata.name)
                if old.status.certificate == obj.status.certificate:
                    return  # certificate unchanged: not a signing write
            except NotFound:
                pass
        if not self._authz.authorize(
            user, "sign", "signers", "", obj.spec.signer_name
        ):
            raise AdmissionDenied(
                f"user {user.name!r} may not sign requests for signer "
                f"{obj.spec.signer_name!r}"
            )
