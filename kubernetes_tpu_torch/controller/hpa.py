"""HorizontalPodAutoscaler controller (autoscaling/v1 semantics).

Reference: pkg/controller/podautoscaler/horizontal.go (reconcileAutoscaler)
— every sync period, read the target's current CPU utilization from the
metrics API, compute

    desired = ceil(currentReplicas * currentUtilization / targetUtilization)

clamp to [minReplicas, maxReplicas], tolerate ±10% around the target
(the controller's `tolerance`), and write the scale subresource.

The reference reads utilization from metrics-server (an external
component); this build injects a ``metrics_client(pods) -> {pod_key:
millicores}`` callable. The default reads each pod's
``metrics.kubernetes.io/cpu-usage`` annotation (millicores) — hollow
runtimes and tests set it — which keeps the controller logic identical
while the metrics pipeline stays out-of-process, exactly like the
reference.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import objects as v1
from ..api.resources import cpu_to_millis
from ..client.apiserver import NotFound
from .base import WorkqueueController, match_labels

logger = logging.getLogger("kubernetes_tpu.controller.hpa")

CPU_USAGE_ANNOTATION = "metrics.kubernetes.io/cpu-usage"
TOLERANCE = 0.1  # horizontal.go tolerance
SCALE_TARGETS = {
    "Deployment": "deployments",
    "ReplicaSet": "replicasets",
    "StatefulSet": "statefulsets",
}


def annotation_metrics_client(pods: List[v1.Pod]) -> Dict[str, int]:
    """Default metrics source: per-pod cpu-usage annotation in millicores."""
    out = {}
    for p in pods:
        raw = p.metadata.annotations.get(CPU_USAGE_ANNOTATION)
        if raw is None:
            continue
        try:
            out[p.metadata.key] = cpu_to_millis(raw)
        except ValueError:
            pass
    return out


class HPAController(WorkqueueController):
    name = "horizontalpodautoscaling"
    primary_kind = "horizontalpodautoscalers"
    secondary_kinds = ()

    def __init__(
        self,
        server,
        workers: int = 1,
        sync_period: float = 5.0,
        metrics_client: Optional[Callable] = None,
    ):
        super().__init__(server, workers=workers)
        self.sync_period = sync_period
        self.metrics_client = metrics_client or annotation_metrics_client

    def start(self) -> None:
        super().start()
        # periodic re-evaluation (the reference reconciles every
        # --horizontal-pod-autoscaler-sync-period, default 15s)
        self.start_ticker("hpa-resync", self.sync_period, self._enqueue_all)

    def _enqueue_all(self) -> None:
        hpas, _ = self.server.list("horizontalpodautoscalers")
        for h in hpas:
            self.queue.add(h.metadata.key)

    # -- reconcile ------------------------------------------------------------

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            hpa = self.server.get("horizontalpodautoscalers", ns, name)
        except NotFound:
            return
        resource = SCALE_TARGETS.get(hpa.spec.scale_target_ref.kind)
        if resource is None:
            logger.warning("hpa %s: unsupported target %s", key, hpa.spec.scale_target_ref.kind)
            return
        try:
            target = self.server.get(resource, ns, hpa.spec.scale_target_ref.name)
        except NotFound:
            return
        current = target.spec.replicas

        desired, utilization = self._desired_replicas(hpa, target, ns, current)
        desired = max(hpa.spec.min_replicas, min(hpa.spec.max_replicas, desired))

        if desired != current:
            def scale(obj):
                obj.spec.replicas = desired
                return obj

            try:
                self.server.guaranteed_update(
                    resource, ns, hpa.spec.scale_target_ref.name, scale
                )
            except NotFound:
                return

        def set_status(h):
            h.status.current_replicas = current
            h.status.desired_replicas = desired
            h.status.current_cpu_utilization_percentage = utilization
            if desired != current:
                h.status.last_scale_time = time.time()
            h.status.observed_generation = h.metadata.generation
            return h

        try:
            self.server.guaranteed_update(
                "horizontalpodautoscalers", ns, name, set_status
            )
        except NotFound:
            pass

    def _desired_replicas(self, hpa, target, ns: str, current: int):
        """(desired, currentUtilizationPct|None) — the v1 CPU-utilization
        rule with the ±tolerance dead band (horizontal.go
        computeReplicasForMetrics -> GetResourceReplicas)."""
        if hpa.spec.target_cpu_utilization_percentage is None or current == 0:
            return current, None
        pods = [
            p
            for p in self.server.list("pods", namespace=ns)[0]
            if p.metadata.deletion_timestamp is None
            and match_labels(target.spec.selector, p.metadata.labels)
        ]
        if not pods:
            return current, None
        usage = self.metrics_client(pods)
        measured = [p for p in pods if p.metadata.key in usage]
        if not measured:
            return current, None
        total_usage = sum(usage[p.metadata.key] for p in measured)
        total_request = 0
        for p in measured:
            req = v1.compute_pod_resource_request(p).get("cpu", 0)
            if req <= 0:
                return current, None  # missing requests: skip (reference errors)
            total_request += req
        utilization = int(round(100.0 * total_usage / total_request))
        target_pct = hpa.spec.target_cpu_utilization_percentage
        ratio = utilization / target_pct
        if abs(ratio - 1.0) <= TOLERANCE:
            return current, utilization
        return int(math.ceil(ratio * len(measured))), utilization
