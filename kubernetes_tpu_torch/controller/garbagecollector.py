"""Garbage collector: cascade-delete objects whose owner is gone.

Reference: pkg/controller/garbagecollector — the dependency graph of
ownerReferences; orphaned dependents (owner uid no longer exists) are
deleted. Reduced to the kinds the framework serves; same observable
behavior for the scheduler-relevant cascade (ReplicaSet → Pods).
"""

from __future__ import annotations

import logging
import threading

from ..client.apiserver import NotFound

logger = logging.getLogger("kubernetes_tpu.controller.gc")

# kinds that can own / be owned, by kind string -> resource
_KIND_RESOURCES = {
    "ReplicaSet": "replicasets",
    "Pod": "pods",
    "Service": "services",
    "Deployment": "deployments",
    "Job": "jobs",
    "DaemonSet": "daemonsets",
    "StatefulSet": "statefulsets",
}
_DEPENDENT_RESOURCES = ("pods", "replicasets")


class GarbageCollector:
    def __init__(self, server, period: float = 2.0):
        self.server = server
        self.period = period
        self._stop = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._run, daemon=True, name="gc").start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._collect_once()
            except Exception:
                logger.exception("gc pass failed")
            self._stop.wait(self.period)

    def _collect_once(self) -> None:  # graftlint: degraded-ok(_run catches everything: a degraded delete aborts the pass, retried next period)
        # live uids per owner kind
        live = {}
        for kind, resource in _KIND_RESOURCES.items():
            objs, _ = self.server.list(resource)
            live[kind] = {o.metadata.uid for o in objs}
        for resource in _DEPENDENT_RESOURCES:
            objs, _ = self.server.list(resource)
            for obj in objs:
                refs = obj.metadata.owner_references
                if not refs:
                    continue
                orphaned = all(
                    ref.kind in live and ref.uid not in live[ref.kind]
                    for ref in refs
                    if ref.kind in _KIND_RESOURCES
                )
                relevant = any(ref.kind in _KIND_RESOURCES for ref in refs)
                if relevant and orphaned:
                    try:
                        self.server.delete(
                            resource, obj.metadata.namespace, obj.metadata.name
                        )
                        logger.info(
                            "gc deleted orphaned %s %s",
                            resource,
                            obj.metadata.key,
                        )
                    except NotFound:
                        pass
