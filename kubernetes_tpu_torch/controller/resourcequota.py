"""ResourceQuota controller: track per-namespace usage against hard limits.

Reference: pkg/controller/resourcequota/resource_quota_controller.go —
recalculates ``status.used`` for every quota whenever objects it tracks
change (pods by default here: pod count, requests.cpu, requests.memory),
plus a full resync. ENFORCEMENT is the quota admission plugin's job
(apiserver/admission.py); this controller only keeps status current — the
same split as the reference (controller = accounting, admission = gate).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

from ..api import objects as v1
from ..api.resources import CPU, MEMORY
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.resourcequota")

# quota resource names we account (reference: evaluator core.Pod)
Q_PODS = "pods"
Q_REQ_CPU = "requests.cpu"
Q_REQ_MEM = "requests.memory"
Q_CPU = "cpu"  # alias of requests.cpu (v1 compatibility)
Q_MEM = "memory"


def compute_namespace_usage(
    server, namespace: str, scopes=()
) -> Dict[str, int]:
    """Usage for one namespace, restricted to pods matching `scopes`
    (reference quota scope selection, evaluator/core/pods.go). Terminal
    pods don't count (the evaluator skips Succeeded/Failed pods)."""
    from ..apiserver.admission import pod_matches_scopes

    pods, _ = server.list("pods", namespace=namespace)
    live = [
        p
        for p in pods
        if p.metadata.deletion_timestamp is None
        and p.status.phase not in (v1.POD_SUCCEEDED, v1.POD_FAILED)
        and (not scopes or pod_matches_scopes(p, scopes))
    ]
    cpu = mem = 0
    for p in live:
        req = v1.compute_pod_resource_request(p)
        cpu += int(req.get(CPU, 0))
        mem += int(req.get(MEMORY, 0))
    return {
        Q_PODS: len(live),
        Q_REQ_CPU: cpu,
        Q_CPU: cpu,
        Q_REQ_MEM: mem,
        Q_MEM: mem,
    }


class ResourceQuotaController(WorkqueueController):
    name = "resourcequota"
    primary_kind = "resourcequotas"
    secondary_kinds = ("pods",)

    def __init__(self, server, workers: int = 1, resync_period: float = 10.0):
        super().__init__(server, workers=workers)
        self.resync_period = resync_period

    def start(self) -> None:
        super().start()
        self.start_ticker("quota-resync", self.resync_period, self._enqueue_all)

    def _enqueue_all(self) -> None:
        quotas, _ = self.server.list("resourcequotas")
        for q in quotas:
            self.queue.add(q.metadata.key)

    def enqueue_for_related(self, resource: str, obj):
        # a pod event re-syncs every quota in its namespace
        quotas, _ = self.server.list(
            "resourcequotas", namespace=obj.metadata.namespace
        )
        for q in quotas:
            self.queue.add(q.metadata.key)
        return None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            quota = self.server.get("resourcequotas", ns, name)
        except NotFound:
            return
        usage = compute_namespace_usage(self.server, ns, quota.spec.scopes)
        used = {r: usage.get(r, 0) for r in quota.spec.hard}

        def mutate(cur):
            if cur.status.used == used and cur.status.hard == cur.spec.hard:
                return None
            cur.status.hard = dict(cur.spec.hard)
            cur.status.used = used
            return cur

        try:
            self.server.guaranteed_update("resourcequotas", ns, name, mutate)
        except NotFound:
            pass
