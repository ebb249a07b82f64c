"""TTL controllers.

1. ``TTLController`` — reference pkg/controller/ttl/ttl_controller.go:
   annotate every node with ``node.alpha.kubernetes.io/ttl``, the
   secret/configmap kubelet-cache TTL, stepped by cluster size (0s under
   100 nodes, 15s under 500, 30s under 1000, 60s above — the reference's
   ttlBoundaries).

2. ``TTLAfterFinishedController`` — reference
   pkg/controller/ttlafterfinished/ttlafterfinished_controller.go: delete
   finished Jobs ``spec.ttl_seconds_after_finished`` seconds after they
   complete or fail.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..api import objects as v1
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.ttl")

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"
# (max cluster size for this tier, ttl seconds) — ttl_controller.go boundaries
TTL_BOUNDARIES = [(100, 0), (500, 15), (1000, 30), (1 << 62, 60)]


def ttl_for_cluster_size(n: int) -> int:
    for bound, ttl in TTL_BOUNDARIES:
        if n <= bound:
            return ttl
    return 60


class TTLController(WorkqueueController):
    name = "ttl"
    primary_kind = "nodes"
    secondary_kinds = ()

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")  # store key carries the namespace
        want = str(ttl_for_cluster_size(self.server.count("nodes")))

        def mutate(node):
            if node.metadata.annotations.get(TTL_ANNOTATION) == want:
                return None
            node.metadata.annotations[TTL_ANNOTATION] = want
            return node

        try:
            self.server.guaranteed_update("nodes", ns, name, mutate)
        except NotFound:
            pass


class TTLAfterFinishedController(WorkqueueController):
    name = "ttlafterfinished"
    primary_kind = "jobs"
    secondary_kinds = ()

    def __init__(self, server, workers: int = 1, tick: float = 1.0):
        super().__init__(server, workers=workers)
        self.tick = tick

    def start(self) -> None:
        super().start()
        # expirations fire by time, not by watch events
        self.start_ticker("ttlafterfinished-tick", self.tick, self._enqueue_ttl_jobs)

    def _enqueue_ttl_jobs(self) -> None:
        jobs, _ = self.server.list("jobs")
        for j in jobs:
            if getattr(j.spec, "ttl_seconds_after_finished", None) is not None:
                self.queue.add(j.metadata.key)

    @staticmethod
    def _finish_time(job: v1.Job) -> Optional[float]:
        times = [
            c.last_transition_time
            for c in job.status.conditions
            if c.type in ("Complete", "Failed") and c.status == "True"
        ]
        return max(times) if times else None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            job = self.server.get("jobs", ns, name)
        except NotFound:
            return
        ttl = getattr(job.spec, "ttl_seconds_after_finished", None)
        if ttl is None:
            return
        finished = self._finish_time(job)
        if finished is None:
            return
        if time.time() - finished >= ttl:
            try:
                self.server.delete("jobs", ns, name)
            except NotFound:
                pass
