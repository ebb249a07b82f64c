"""Kubelet volume manager: the node side of the volume path.

Reference: pkg/kubelet/volumemanager/volume_manager.go — a desired-state
populator (what the node's pods need mounted) and a reconciler
(WaitForAttach → MountDevice → SetUp per pod; TearDown/UnmountDevice when
pods go away), reporting VolumesInUse on the node status so the
attach-detach controller never detaches a volume the node still uses
(the safe-detach contract).

This build's "mount" is bookkeeping (there is no real filesystem, exactly
like kubemark's hollow kubelet faking the mounter), but the state machine
and its ordering are real:

  pod needs PVC -> PVC bound to PV -> VolumeAttachment(pv, node) attached
      -> device "mounted" (node-global) -> pod volume "set up"
  pod gone -> pod volume torn down -> last user unmounts the device
      -> volumes_in_use drops the PV -> the AD controller may detach

The kubelet defers starting a PVC-bearing pod until its volumes are set
up, and housekeeping retries — the reference's pod-worker wait on
volumemanager.WaitForAttachAndMount.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set

from ..api import objects as v1
from ..client.apiserver import NotFound
from ..runtime.consensus import DegradedWrites
from .kubelet import skip_degraded_write

logger = logging.getLogger("kubernetes_tpu.kubelet.volumemanager")


class VolumeManager:
    def __init__(self, server, node_name: str, csi=None):
        self.server = server
        self.node_name = node_name
        # CSI boundary (kubelet/csi.py): csi-backed PVs additionally drive
        # the external driver's node service around these transitions
        # (reference csi_client.go); None = no CSI support on this node
        self.csi = csi
        self._lock = threading.Lock()
        # desired: pod key -> set of PV names
        self._desired: Dict[str, Set[str]] = {}
        # actual: PV -> set of pod keys it is set up for (device-mounted
        # while non-empty)
        self._mounted: Dict[str, Set[str]] = {}
        self._last_reported: Optional[List[str]] = None

    # -- desired state populator --------------------------------------------

    def note_pod(self, pod: v1.Pod) -> None:
        """Track a pod's PV needs (desired_state_of_world populator)."""
        pvs = self._pod_pvs(pod)
        with self._lock:
            if pvs:
                self._desired[pod.metadata.key] = pvs
            else:
                self._desired.pop(pod.metadata.key, None)

    def forget_pod(self, pod_key: str) -> None:
        with self._lock:
            self._desired.pop(pod_key, None)

    def _pod_pvs(self, pod: v1.Pod) -> Set[str]:
        out: Set[str] = set()
        for vol in pod.spec.volumes:
            if not vol.persistent_volume_claim:
                continue
            try:
                pvc = self.server.get(
                    "persistentvolumeclaims",
                    pod.metadata.namespace,
                    vol.persistent_volume_claim,
                )
            except NotFound:
                continue
            if pvc.spec.volume_name:
                out.add(pvc.spec.volume_name)
        return out

    # -- reconciler ----------------------------------------------------------

    def reconcile(self) -> None:
        """One reconciler pass (reconciler.go reconcile()): mount what is
        desired and attached, tear down what is no longer desired, then
        report volumes_in_use. CSI-backed PVs drive the external driver
        around each transition; the driver calls run OUTSIDE the lock (a
        slow/dead driver must not block the populator), and a failed call
        leaves the pair un-mounted for the next pass to retry."""
        with self._lock:
            desired = {k: set(v) for k, v in self._desired.items()}
        attached = self._attached_pvs()
        setups: List = []  # (pod_key, pv)
        teardowns: List = []  # (pod_key, pv, last_user)
        with self._lock:
            for pod_key, pvs in desired.items():
                for pv in pvs:
                    users = self._mounted.get(pv, set())
                    if pod_key not in users and pv in attached:
                        setups.append((pod_key, pv))
            for pv, users in self._mounted.items():
                stale = [k for k in users if pv not in desired.get(k, ())]
                for n, pod_key in enumerate(stale, start=1):
                    teardowns.append(
                        (pod_key, pv, n == len(stale) == len(users))
                    )
        done_setups = []
        for pod_key, pv in setups:
            src = self._csi_source(pv)
            if src is not None:
                if self.csi is None or not self.csi.has_driver(src.driver):
                    continue  # no driver yet: stays pending, retried
                try:
                    self.csi.stage_and_publish(src, pod_key)
                except Exception as e:  # CSIError and transport faults
                    logger.warning("csi setup %s/%s: %s", pv, pod_key, e)
                    continue
            done_setups.append((pod_key, pv))
        done_teardowns = []
        for pod_key, pv, last_user in teardowns:
            src = self._csi_source(pv)
            if src is not None and self.csi is not None:
                if not self.csi.unpublish(src, pod_key, last_user):
                    # driver fault: keep the pair mounted so the next
                    # pass re-issues the teardown (no driver-side leak)
                    continue
            done_teardowns.append((pod_key, pv))
        with self._lock:
            for pod_key, pv in done_setups:
                # MountDevice (first user) + SetUp
                self._mounted.setdefault(pv, set()).add(pod_key)
            for pod_key, pv in done_teardowns:
                users = self._mounted.get(pv)
                if users is not None:
                    users.discard(pod_key)  # TearDown
                    if not users:
                        del self._mounted[pv]  # UnmountDevice
            in_use = sorted(
                set(self._mounted)
                | {pv for pvs in desired.values() for pv in pvs}
            )
        self._report_volumes_in_use(in_use)

    def _csi_source(self, pv_name: str):
        """The PV's csi source, or None for in-tree volumes."""
        try:
            pv = self.server.get("persistentvolumes", "", pv_name)
        except NotFound:
            return None
        return pv.spec.csi

    def _attached_pvs(self) -> Set[str]:
        try:
            attachments, _ = self.server.list("volumeattachments")
        except Exception:
            return set()
        return {
            a.spec.pv_name
            for a in attachments
            if a.spec.node_name == self.node_name and a.status.attached
        }

    def _report_volumes_in_use(self, in_use: List[str]) -> None:
        """node.status.volumesInUse (VolumeManager.GetVolumesInUse → node
        status updater): the AD controller's safe-detach input."""
        if in_use == self._last_reported:
            return

        def mutate(node):
            if node.status.volumes_in_use == in_use:
                return None
            node.status.volumes_in_use = list(in_use)
            node.status.volumes_attached = sorted(self._attached_pvs())
            return node

        try:
            self.server.guaranteed_update("nodes", "", self.node_name, mutate)
            self._last_reported = list(in_use)
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("volumes_in_use")

    # -- the pod-worker wait (WaitForAttachAndMount) -------------------------

    def mounts_ready(self, pod: v1.Pod) -> bool:
        """True when every PV the pod needs is set up for it (or it needs
        none). The kubelet blocks pod start on this."""
        pvs = self._pod_pvs(pod)
        if not pvs:
            return True
        key = pod.metadata.key
        with self._lock:
            return all(key in self._mounted.get(pv, ()) for pv in pvs)

    def mounted_for(self, pod_key: str) -> List[str]:
        with self._lock:
            return sorted(
                pv for pv, users in self._mounted.items() if pod_key in users
            )
