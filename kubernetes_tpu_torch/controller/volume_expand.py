"""Volume expansion controller.

Reference: pkg/controller/volume/expand/expand_controller.go — a PVC whose
requested size grows past its provisioned capacity triggers a resize,
gated on the StorageClass's allowVolumeExpansion. The reference splits the
work between a control-plane resize (PV capacity) and a node filesystem
resize (kubelet); this build's runtimes have no filesystems, so the
controller performs both halves: grow the bound PV's capacity, then
reflect it in pvc.status.capacity (the reference's markResizeFinished).
Shrinking is rejected by validation there and ignored here.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..api import objects as v1
from ..api.resources import parse_quantity
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.volume_expand")


class VolumeExpandController(WorkqueueController):
    name = "persistentvolume-expander"
    primary_kind = "persistentvolumeclaims"
    secondary_kinds = ()

    def __init__(self, server, workers: int = 1):
        super().__init__(server, workers=workers)

    def _class_of(self, pvc) -> Optional[v1.StorageClass]:
        if not pvc.spec.storage_class_name:
            return None
        try:
            return self.server.get(
                "storageclasses", "", pvc.spec.storage_class_name
            )
        except NotFound:
            return None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            pvc = self.server.get("persistentvolumeclaims", ns, name)
        except NotFound:
            return
        if not pvc.spec.volume_name or pvc.status.phase != v1.CLAIM_BOUND:
            return  # only bound claims resize
        want = pvc.spec.resources.get("storage")
        if want is None:
            return
        have = pvc.status.capacity.get("storage")
        if have is None:
            # claim bound before status.capacity existed (older WAL):
            # baseline from the bound PV's provisioned size
            try:
                pv = self.server.get(
                    "persistentvolumes", "", pvc.spec.volume_name
                )
            except NotFound:
                return
            have = pv.spec.capacity.get("storage")
            if have is None:
                return
        if parse_quantity(want) <= parse_quantity(have):
            return
        sc = self._class_of(pvc)
        if sc is None or not sc.allow_volume_expansion:
            logger.info(
                "expand: PVC %s wants %s but class %r forbids expansion",
                key, want, pvc.spec.storage_class_name,
            )
            return

        # control-plane half: grow the PV
        def grow_pv(pv):
            cur = pv.spec.capacity.get("storage")
            if cur is not None and parse_quantity(cur) >= parse_quantity(want):
                return None
            pv.spec.capacity["storage"] = want
            return pv

        try:
            self.server.guaranteed_update(
                "persistentvolumes", "", pvc.spec.volume_name, grow_pv
            )
        except NotFound:
            return  # PV vanished; claim will be re-synced on events

        # "node" half: publish the new size on the claim status
        def finish(cur):
            h = cur.status.capacity.get("storage")
            if h is not None and parse_quantity(h) >= parse_quantity(want):
                return None
            cur.status.capacity["storage"] = want
            return cur

        try:
            self.server.guaranteed_update(
                "persistentvolumeclaims", ns, name, finish
            )
            logger.info("expand: PVC %s resized %s -> %s", key, have, want)
        except NotFound:
            pass
