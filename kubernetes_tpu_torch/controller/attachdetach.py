"""Attach/detach controller: VolumeAttachment objects follow pod placement.

Reference: pkg/controller/volume/attachdetach — reconciles the desired
state (pods scheduled to nodes referencing PV-backed volumes) against the
actual state (VolumeAttachment objects): attach volumes whose pods landed
on a node, detach when no pod on that node uses the volume anymore.
Attachment names are deterministic hashes of (pv, node) — like the
reference's GetAttachmentName — so reconcile is idempotent and distinct
pairs can't collide. The hollow runtime "attaches" instantly
(status.attached) the way kubemark fakes the mounter.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, Optional, Set, Tuple

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.attachdetach")


def _pod_pv_names(server, pod: v1.Pod) -> Set[str]:
    """PVs referenced by the pod via bound PVCs."""
    out: Set[str] = set()
    for vol in pod.spec.volumes:
        if not vol.persistent_volume_claim:
            continue
        try:
            pvc = server.get(
                "persistentvolumeclaims",
                pod.metadata.namespace,
                vol.persistent_volume_claim,
            )
        except NotFound:
            continue
        if pvc.spec.volume_name:
            out.add(pvc.spec.volume_name)
    return out


class AttachDetachController(WorkqueueController):
    name = "attachdetach"
    primary_kind = "pods"
    # nodes: a volumes_in_use drop (kubelet unmounted) must retry the
    # delayed safe detach
    secondary_kinds = ("persistentvolumeclaims", "nodes")

    def primary_key_of(self, obj) -> str:
        # sync() rebuilds the whole desired-state-of-world; a constant key
        # lets the workqueue collapse a pod burst into ONE rebuild instead
        # of N full-cluster scans
        return "reconcile"

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        return "reconcile"  # PVC binding changes: same world rebuild

    def sync(self, key: str) -> None:
        # desired state of the WORLD, not of one pod: rebuild the full
        # (pv, node) -> wanted map like the reference's reconciler loop —
        # per-pod increments can't handle detach-on-delete (the pod is gone)
        pods, _ = self.server.list("pods")
        wanted: Dict[Tuple[str, str], bool] = {}
        for p in pods:
            if not p.spec.node_name or p.metadata.deletion_timestamp is not None:
                continue
            for pv_name in _pod_pv_names(self.server, p):
                wanted[(pv_name, p.spec.node_name)] = True

        attachments, _ = self.server.list("volumeattachments")
        have = {(a.spec.pv_name, a.spec.node_name): a for a in attachments}

        for (pv_name, node_name) in wanted:
            if (pv_name, node_name) in have:
                continue
            # hashed name (GetAttachmentName): "pv-a"+"b" vs "pv"+"a-b"
            # must not collide
            digest = hashlib.sha1(
                f"{pv_name}^{node_name}".encode()
            ).hexdigest()[:20]
            va = v1.VolumeAttachment(
                metadata=v1.ObjectMeta(name=f"va-{digest}", namespace=""),
                spec=v1.VolumeAttachmentSpec(
                    attacher=self._attacher_of(pv_name),
                    node_name=node_name,
                    pv_name=pv_name,
                ),
                status=v1.VolumeAttachmentStatus(attached=True),
            )
            try:
                self.server.create("volumeattachments", va)
            except AlreadyExists:
                pass
        for (pv_name, node_name), a in have.items():
            if (pv_name, node_name) not in wanted:
                # safe detach: never while the node still reports the
                # volume in use (volumes_in_use, the kubelet volume
                # manager's mount bookkeeping — reconciler.go's
                # "operation not permitted while mounted" contract)
                if pv_name in self._volumes_in_use(node_name):
                    logger.info(
                        "delaying detach of %s from %s: still in use",
                        pv_name,
                        node_name,
                    )
                    continue
                try:
                    self.server.delete(
                        "volumeattachments",
                        a.metadata.namespace,
                        a.metadata.name,
                    )
                except NotFound:
                    pass

    def _volumes_in_use(self, node_name: str) -> Set[str]:
        try:
            node = self.server.get("nodes", "", node_name)
        except NotFound:
            try:
                node = self.server.get("nodes", "default", node_name)
            except NotFound:
                return set()
        return set(node.status.volumes_in_use)

    def _attacher_of(self, pv_name: str) -> str:
        try:
            pv = self.server.get("persistentvolumes", "", pv_name)
        except NotFound:
            try:
                pv = self.server.get("persistentvolumes", "default", pv_name)
            except NotFound:
                return ""
        s = pv.spec
        if s.csi:
            return s.csi.driver
        for attr, drv in (
            ("gce_persistent_disk", "kubernetes.io/gce-pd"),
            ("aws_elastic_block_store", "kubernetes.io/aws-ebs"),
            ("azure_disk", "kubernetes.io/azure-disk"),
            ("cinder", "kubernetes.io/cinder"),
        ):
            if getattr(s, attr, None):
                return drv
        return "kubernetes.io/no-op"
