"""Namespace controller: terminating namespaces drain their objects.

Reference: pkg/controller/namespace — deleting a Namespace sweeps every
namespaced resource inside it, then removes the namespace once empty.
Deletion is modeled by phase=Terminating (set by the API layer or client).
"""

from __future__ import annotations

import logging
import threading

from ..client.apiserver import NotFound

logger = logging.getLogger("kubernetes_tpu.controller.namespace")

NAMESPACED_RESOURCES = ("pods", "replicasets", "services", "persistentvolumeclaims")


class NamespaceController:
    def __init__(self, server, period: float = 1.0):
        self.server = server
        self.period = period
        self._stop = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._run, daemon=True, name="namespace").start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._sync_once()
            except Exception:
                logger.exception("namespace sync failed")
            self._stop.wait(self.period)

    def _sync_once(self) -> None:  # graftlint: degraded-ok(_run catches everything: a degraded delete aborts the pass, retried next period)
        namespaces, _ = self.server.list("namespaces")
        for ns in namespaces:
            if ns.phase != "Terminating":
                continue
            remaining = 0
            for resource in NAMESPACED_RESOURCES:
                objs, _ = self.server.list(resource, namespace=ns.metadata.name)
                for obj in objs:
                    remaining += 1
                    try:
                        self.server.delete(
                            resource, obj.metadata.namespace, obj.metadata.name
                        )
                    except NotFound:
                        pass
            if remaining == 0:
                try:
                    self.server.delete("namespaces", "", ns.metadata.name)
                    logger.info("namespace %s deleted", ns.metadata.name)
                except NotFound:
                    pass
