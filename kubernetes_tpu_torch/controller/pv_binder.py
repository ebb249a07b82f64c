"""PersistentVolume binder controller: match pending claims to volumes.

Reference: pkg/controller/volume/persistentvolume (pv_controller.go
syncUnboundClaim / syncVolume) — for every Pending PVC with immediate
binding: find the smallest Available PV satisfying class, access modes and
capacity; bind both sides (pv.spec.claimRef <-> pvc.spec.volumeName) and
set both phases Bound. Claims in WaitForFirstConsumer classes are left for
the scheduler's VolumeBinding plugin (controller/volume_scheduling.py).
Deleted claims release their volume (Released; no reclaim policies here).
Classes with a provisioner dynamically create a matching PV first — the
in-process analogue of scheduler_perf's StartFakePVController
(test/integration/util/util.go:110).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..api import objects as v1
from ..api.resources import parse_quantity
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.pv_binder")


class PVBinderController(WorkqueueController):
    name = "persistentvolume-binder"
    primary_kind = "persistentvolumeclaims"
    secondary_kinds = ("persistentvolumes",)

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        # a PV event re-queues every pending claim (cheap: claims are few)
        claims, _ = self.server.list("persistentvolumeclaims")
        for c in claims:
            if c.status.phase == v1.CLAIM_PENDING:
                self.queue.add(c.metadata.key)
        return None

    # -- reconcile ------------------------------------------------------------

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            pvc = self.server.get("persistentvolumeclaims", ns, name)
        except NotFound:
            self._release_volume_of(key)
            return
        if pvc.spec.volume_name:
            self._ensure_bound_phases(pvc)
            return
        sc = self._class_of(pvc)
        if sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer":
            return  # the scheduler binds these at placement time
        pv = self._find_available_pv(pvc)
        if pv is None and sc is not None and sc.provisioner:
            pv = self._provision(pvc, sc)
        if pv is None:
            return  # stay Pending; retried on PV events
        self._bind(pvc, pv)

    # -- helpers --------------------------------------------------------------

    def _class_of(self, pvc) -> Optional[v1.StorageClass]:
        if not pvc.spec.storage_class_name:
            return None
        try:
            return self.server.get(
                "storageclasses", "", pvc.spec.storage_class_name
            )
        except NotFound:
            try:
                return self.server.get(
                    "storageclasses", "default", pvc.spec.storage_class_name
                )
            except NotFound:
                return None

    def _find_available_pv(self, pvc) -> Optional[v1.PersistentVolume]:
        pvs, _ = self.server.list("persistentvolumes")
        want = parse_quantity(pvc.spec.resources.get("storage", 0))
        cands = []
        for pv in pvs:
            if pv.spec.claim_ref or pv.status.phase != "Available":
                continue
            if (pv.spec.storage_class_name or "") != (
                pvc.spec.storage_class_name or ""
            ):
                continue
            if pvc.spec.access_modes and not set(pvc.spec.access_modes) <= set(
                pv.spec.access_modes
            ):
                continue
            cap = parse_quantity(pv.spec.capacity.get("storage", 0))
            if cap < want:
                continue
            cands.append((cap, pv))
        # smallest satisfying volume (pv_controller's findBestMatch)
        return min(cands, key=lambda t: t[0])[1] if cands else None

    def _provision(self, pvc, sc) -> Optional[v1.PersistentVolume]:
        pv = v1.PersistentVolume(
            metadata=v1.ObjectMeta(name=f"pvc-{pvc.metadata.uid}", namespace=""),
            spec=v1.PersistentVolumeSpec(
                capacity={"storage": pvc.spec.resources.get("storage", "1Gi")},
                access_modes=list(pvc.spec.access_modes) or ["ReadWriteOnce"],
                storage_class_name=pvc.spec.storage_class_name or "",
                csi=v1.CSIVolumeSource(
                    driver=sc.provisioner, volume_handle=f"pvc-{pvc.metadata.uid}"
                ),
            ),
        )
        try:
            return self.server.create("persistentvolumes", pv)
        except AlreadyExists:
            try:
                return self.server.get(
                    "persistentvolumes", "", pv.metadata.name
                )
            except NotFound:
                return None

    def _bind(self, pvc, pv) -> None:
        claim_key = pvc.metadata.key

        def bind_pv(p):
            if p.spec.claim_ref and p.spec.claim_ref != claim_key:
                return None  # raced: another claim took it
            p.spec.claim_ref = claim_key
            p.status.phase = "Bound"
            return p

        try:
            updated = self.server.guaranteed_update(
                "persistentvolumes", pv.metadata.namespace, pv.metadata.name, bind_pv
            )
        except NotFound:
            return
        if updated.spec.claim_ref != claim_key:
            return  # lost the race; the claim retries on the next PV event

        def bind_pvc(c):
            c.spec.volume_name = pv.metadata.name
            c.status.phase = v1.CLAIM_BOUND
            # provisioned size baseline the expand controller compares
            # spec.resources against (pv_controller's bindClaimToVolume
            # copies volume capacity into claim status)
            if "storage" in pv.spec.capacity:
                c.status.capacity["storage"] = pv.spec.capacity["storage"]
            return c

        try:
            self.server.guaranteed_update(
                "persistentvolumeclaims",
                pvc.metadata.namespace,
                pvc.metadata.name,
                bind_pvc,
            )
        except NotFound:
            # claim vanished mid-bind: release the volume again
            self._release(pv.metadata)

    def _ensure_bound_phases(self, pvc) -> None:
        if pvc.status.phase != v1.CLAIM_BOUND:
            def mark(c):
                if c.status.phase == v1.CLAIM_BOUND:
                    return None
                c.status.phase = v1.CLAIM_BOUND
                return c

            try:
                self.server.guaranteed_update(
                    "persistentvolumeclaims",
                    pvc.metadata.namespace,
                    pvc.metadata.name,
                    mark,
                )
            except NotFound:
                pass

    def _release_volume_of(self, claim_key: str) -> None:
        pvs, _ = self.server.list("persistentvolumes")
        for pv in pvs:
            if pv.spec.claim_ref == claim_key:
                def release(p):
                    p.spec.claim_ref = None
                    p.status.phase = "Released"
                    return p

                try:
                    self.server.guaranteed_update(
                        "persistentvolumes",
                        pv.metadata.namespace,
                        pv.metadata.name,
                        release,
                    )
                except NotFound:
                    pass

    def _release(self, pv_meta) -> None:
        def release(p):
            p.spec.claim_ref = None
            p.status.phase = "Available"
            return p

        try:
            self.server.guaranteed_update(
                "persistentvolumes", pv_meta.namespace, pv_meta.name, release
            )
        except NotFound:
            pass
