"""Pod garbage collector + protection finalizer controllers.

1. ``PodGCController`` — reference pkg/controller/podgc/gc_controller.go:
   delete terminated pods beyond ``terminated_pod_threshold`` (oldest
   first), pods bound to nodes that no longer exist, and deletion-pending
   pods that never got scheduled (gcUnscheduledTerminating).

2. ``PVCProtectionController`` / ``PVProtectionController`` — reference
   pkg/controller/volume/{pvcprotection,pvprotection}: objects carry a
   protection finalizer while in use; deletion is deferred (the store's
   deletion_timestamp marks intent) until no live pod references the PVC /
   no claim references the PV, then stripping the finalizer completes the
   deferred deletion (store update() removes deletion-pending
   finalizer-free objects). Both are one shared state machine
   parameterized by (finalizer, in_use predicate).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.podgc")

PVC_FINALIZER = "kubernetes.io/pvc-protection"
PV_FINALIZER = "kubernetes.io/pv-protection"


class PodGCController(WorkqueueController):
    name = "podgc"
    primary_kind = "pods"
    secondary_kinds = ()

    def __init__(
        self, server, workers: int = 1, terminated_pod_threshold: int = 1000,
        tick: float = 20.0,
    ):
        # tick matches the reference's gcCheckPeriod (20s): the sweep
        # deep-copies the pod world, so it must not run hot
        super().__init__(server, workers=workers)
        self.threshold = terminated_pod_threshold
        self.tick = tick

    def primary_key_of(self, obj) -> str:
        return "gc"  # world sweep; collapse event bursts

    def start(self) -> None:
        super().start()
        self.start_ticker("podgc-tick", self.tick, lambda: self.queue.add("gc"))

    def sync(self, key: str) -> None:
        # copy-free prefilter: skip the world copy when nothing can be
        # collectable (the common steady state)
        n_terminated = self.server.count(
            "pods",
            lambda p: p.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED)
            or p.metadata.deletion_timestamp is not None,
        )
        if n_terminated == 0:
            return
        pods, _ = self.server.list("pods")
        nodes = {n.metadata.name for n in self.server.list("nodes")[0]}
        terminated = [
            p
            for p in pods
            if p.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED)
        ]
        # threshold GC: oldest finished pods beyond the cap
        if self.threshold > 0 and len(terminated) > self.threshold:
            doomed = sorted(
                terminated, key=lambda p: p.metadata.creation_timestamp or 0.0
            )[: len(terminated) - self.threshold]
            for p in doomed:
                self._force_delete(p)
        for p in pods:
            # orphan GC: bound to a node that no longer exists
            if p.spec.node_name and p.spec.node_name not in nodes:
                self._force_delete(p)
            # gcUnscheduledTerminating: deletion-pending and never scheduled
            # — no kubelet will ever act on it, release it now
            elif (
                p.metadata.deletion_timestamp is not None
                and not p.spec.node_name
            ):
                self._force_delete(p)

    def _force_delete(self, pod: v1.Pod) -> None:
        # plain delete: foreign finalizers still gate the actual removal
        # (their owners run cleanup and strip) — podgc must never bypass
        # another component's finalizer, it only expresses deletion intent
        try:
            self.server.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except NotFound:
            pass


class _ProtectionController(WorkqueueController):
    """Shared finalizer state machine: ensure the finalizer on live
    objects; once deletion is requested, hold it until `in_use` clears,
    then strip (which completes the deferred deletion)."""

    finalizer = ""

    def in_use(self, obj) -> bool:  # pragma: no cover — abstract
        raise NotImplementedError

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            obj = self.server.get(self.primary_kind, ns, name)
        except NotFound:
            return
        if self.finalizer not in obj.metadata.finalizers:
            if obj.metadata.deletion_timestamp is None:
                def add_fin(o):
                    if self.finalizer in o.metadata.finalizers:
                        return None
                    o.metadata.finalizers.append(self.finalizer)
                    return o

                try:
                    self.server.guaranteed_update(
                        self.primary_kind, ns, name, add_fin
                    )
                except NotFound:
                    pass
            return
        if obj.metadata.deletion_timestamp is None:
            return
        if self.in_use(obj):
            return  # deletion stays deferred while referenced

        def strip(o):
            if self.finalizer not in o.metadata.finalizers:
                return None
            o.metadata.finalizers.remove(self.finalizer)
            return o

        try:
            self.server.guaranteed_update(self.primary_kind, ns, name, strip)
        except NotFound:
            pass


def _pod_blocks_pvc(pod: v1.Pod, claim_name: str) -> bool:
    """Does this pod hold the claim? Terminated pods don't (the reference
    pvc_protection excludes them); deletion-pending pods still RUNNING on a
    kubelet do (the volume is still mounted)."""
    if pod.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED):
        return False
    return any(
        vol.persistent_volume_claim == claim_name for vol in pod.spec.volumes
    )


class PVCProtectionController(_ProtectionController):
    name = "pvc-protection"
    primary_kind = "persistentvolumeclaims"
    secondary_kinds = ("pods",)
    finalizer = PVC_FINALIZER

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        # only pod transitions touching PVC-backed volumes matter — pod
        # status churn is the hottest stream in the system, so enqueue just
        # the claims this pod references
        for vol in obj.spec.volumes:
            if vol.persistent_volume_claim:
                self.queue.add(
                    f"{obj.metadata.namespace}/{vol.persistent_volume_claim}"
                )
        return None

    def in_use(self, pvc) -> bool:
        ns, claim = pvc.metadata.namespace, pvc.metadata.name
        return (
            self.server.count(
                "pods",
                lambda p, _ns=ns, _c=claim: p.metadata.namespace == _ns
                and _pod_blocks_pvc(p, _c),
            )
            > 0
        )


class PVProtectionController(_ProtectionController):
    name = "pv-protection"
    primary_kind = "persistentvolumes"
    secondary_kinds = ("persistentvolumeclaims",)
    finalizer = PV_FINALIZER

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        if obj.spec.volume_name:
            self.queue.add(obj.spec.volume_name)
        return None

    def in_use(self, pv) -> bool:
        return bool(pv.spec.claim_ref)


class RootCACertPublisher(WorkqueueController):
    """Publish the cluster trust bundle into every namespace as the
    ``kube-root-ca.crt`` ConfigMap (pkg/controller/certificates/rootcacertpublisher).
    The bundle here is the token trust root descriptor (no x509)."""

    name = "root-ca-cert-publisher"
    primary_kind = "namespaces"
    secondary_kinds = ("configmaps",)

    CONFIGMAP = "kube-root-ca.crt"

    def __init__(self, server, workers: int = 1, ca_data: str = "tpu-cluster-trust-root"):
        super().__init__(server, workers=workers)
        self.ca_data = ca_data

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        # deleted/tampered bundle: re-publish (the reference watches the
        # configmaps too, rootcacertpublisher.go)
        if obj.metadata.name != self.CONFIGMAP:
            return None
        for ns in self.server.list("namespaces")[0]:
            if ns.metadata.name == obj.metadata.namespace:
                return ns.metadata.key
        return None

    def sync(self, key: str) -> None:
        name = key.rpartition("/")[2]
        try:
            ns_obj = self.server.get("namespaces", key.rpartition("/")[0], name)
        except NotFound:
            return
        if ns_obj.metadata.deletion_timestamp is not None:
            return
        try:
            cm = self.server.get("configmaps", name, self.CONFIGMAP)
            if cm.data.get("ca.crt") != self.ca_data:
                # tampered bundle: restore it (the reference publisher
                # updates on data mismatch, not just absence)
                def repair(cur):
                    if cur.data.get("ca.crt") == self.ca_data:
                        return None
                    cur.data["ca.crt"] = self.ca_data
                    return cur

                self.server.guaranteed_update(
                    "configmaps", name, self.CONFIGMAP, repair
                )
            return
        except NotFound:
            pass
        try:
            self.server.create(
                "configmaps",
                v1.ConfigMap(
                    metadata=v1.ObjectMeta(name=self.CONFIGMAP, namespace=name),
                    data={"ca.crt": self.ca_data},
                ),
            )
        except AlreadyExists:
            pass
        except Exception:
            logger.exception("publishing %s to %s failed", self.CONFIGMAP, name)
