"""CSI node-driver boundary: the kubelet side of external CSI drivers.

Reference: pkg/volume/csi/csi_client.go — the kubelet dials a driver's
unix socket and drives the CSI node service around pod volume setup:
NodeStageVolume (device mount, once per node) -> NodePublishVolume (per
pod) and the inverse NodeUnpublishVolume -> NodeUnstageVolume. Driver
discovery mirrors the plugin-registration flow
(pkg/kubelet/pluginmanager): a driver announces {name, endpoint} and the
kubelet remembers the socket.

Transport is the same framed unix-socket mini-RPC the device-plugin
manager speaks (kubelet/devicemanager.py) — this build's stand-in for
CSI's gRPC, crossing a real process boundary with the real call
sequence. A driver that is not registered leaves the volume pending
(reconcile retries), exactly like a missing CSI plugin in the
reference.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Dict, List, Optional, Set, Tuple

from .devicemanager import _read_reply, _send_frame

logger = logging.getLogger("kubernetes_tpu.kubelet.csi")


class CSIError(RuntimeError):
    pass


class CSIDriverManager:
    """Registered CSI node drivers + the four node-service calls."""

    def __init__(self, node_name: str = ""):
        self.node_name = node_name
        self._lock = threading.Lock()
        self._drivers: Dict[str, str] = {}  # driver name -> unix socket
        # staged volume handles per driver (NodeStage is once-per-node;
        # publish fans out per pod)
        self._staged: Set[Tuple[str, str]] = set()

    # -- registration (pluginmanager handshake) ------------------------------

    def register(self, driver: str, endpoint: str) -> None:
        with self._lock:
            self._drivers[driver] = endpoint
        logger.info("csi driver %s registered at %s", driver, endpoint)

    def unregister(self, driver: str) -> None:
        with self._lock:
            self._drivers.pop(driver, None)

    def has_driver(self, driver: str) -> bool:
        with self._lock:
            return driver in self._drivers

    def drivers(self) -> List[str]:
        with self._lock:
            return sorted(self._drivers)

    # -- node service --------------------------------------------------------

    def _call(self, driver: str, method: str, payload: dict) -> dict:
        with self._lock:
            endpoint = self._drivers.get(driver)
        if endpoint is None:
            raise CSIError(f"csi driver {driver!r} is not registered")
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10.0)
        try:
            s.connect(endpoint)
            _send_frame(s, method, payload)
            return _read_reply(s)
        except OSError as e:
            raise CSIError(f"csi {driver} {method}: {e}") from e
        finally:
            s.close()

    def stage_and_publish(self, csi_source, pod_key: str) -> None:
        """MountDevice + SetUp for one (pod, csi volume): NodeStageVolume
        on the volume's first use on this node, then NodePublishVolume
        for the pod. Raises CSIError to leave the volume pending."""
        key = (csi_source.driver, csi_source.volume_handle)
        with self._lock:
            staged = key in self._staged
        if not staged:
            self._call(
                csi_source.driver,
                "NodeStageVolume",
                {
                    "volume_id": csi_source.volume_handle,
                    "node": self.node_name,
                },
            )
            with self._lock:
                self._staged.add(key)
        self._call(
            csi_source.driver,
            "NodePublishVolume",
            {
                "volume_id": csi_source.volume_handle,
                "target": pod_key,
                "readonly": bool(csi_source.read_only),
            },
        )

    def unpublish(self, csi_source, pod_key: str, last_user: bool) -> bool:
        """TearDown (+ UnmountDevice when the last pod leaves):
        NodeUnpublishVolume, then NodeUnstageVolume. Returns False on a
        driver fault so the CALLER keeps the pair mounted and the next
        reconcile pass retries — a dead driver must not wedge pod
        deletion, but it must not leak the driver-side publish either."""
        try:
            self._call(
                csi_source.driver,
                "NodeUnpublishVolume",
                {"volume_id": csi_source.volume_handle, "target": pod_key},
            )
            if last_user:
                self._call(
                    csi_source.driver,
                    "NodeUnstageVolume",
                    {"volume_id": csi_source.volume_handle},
                )
                with self._lock:
                    self._staged.discard(
                        (csi_source.driver, csi_source.volume_handle)
                    )
        except CSIError as e:
            logger.warning("csi teardown (retried next pass): %s", e)
            return False
        return True

    def staged(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._staged)
