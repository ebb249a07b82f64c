"""Kubelet node-pressure eviction + QoS classes.

Reference: pkg/kubelet/eviction/eviction_manager.go (synthesize node
conditions from resource-pressure signals, rank and evict victims) and
pkg/apis/core/v1/helper/qos (QoS class derivation). The hollow runtime has
no real memory counters, so the pressure signal is injectable: by default
it is committed memory (sum of pod requests, the only truth this build
has) against allocatable; tests and real runtimes can supply live usage.

Victim ranking mirrors rankMemoryPressure: BestEffort pods first, then
Burstable pods whose usage (requests here) exceeds their requests, then
the rest by descending priority-then-usage — Guaranteed and critical pods
last. An eviction posts the pod's Failed status with reason Evicted, sets
the node's MemoryPressure condition, and taints the node
(node.kubernetes.io/memory-pressure, the scheduler's TaintToleration keeps
new pods away until pressure clears).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

from ..api import objects as v1
from ..api.resources import MEMORY, parse_quantity
from ..client.apiserver import Conflict, NotFound
from ..runtime.consensus import DegradedWrites
from .kubelet import skip_degraded_write

logger = logging.getLogger("kubernetes_tpu.kubelet.eviction")

QOS_GUARANTEED = "Guaranteed"
QOS_BURSTABLE = "Burstable"
QOS_BEST_EFFORT = "BestEffort"

MEMORY_PRESSURE_TAINT = "node.kubernetes.io/memory-pressure"
COND_MEMORY_PRESSURE = "MemoryPressure"


def qos_class(pod: v1.Pod) -> str:
    """pkg/apis/core/v1/helper/qos GetPodQOSClass: Guaranteed iff every
    container has cpu+memory requests == limits (and they are set);
    BestEffort iff no container sets any request or limit; else Burstable."""
    containers = list(pod.spec.containers) + list(pod.spec.init_containers)
    if not any(c.requests or c.limits for c in containers):
        return QOS_BEST_EFFORT
    for c in containers:
        for res in ("cpu", "memory"):
            req = c.requests.get(res)
            lim = c.limits.get(res)
            if req is None or lim is None or str(req) != str(lim):
                return QOS_BURSTABLE
    return QOS_GUARANTEED


class EvictionManager:
    """One per node. `usage_fn(pod) -> bytes` supplies per-pod memory
    usage (default: the pod's memory request — committed memory is the
    only signal a hollow runtime has); available memory is
    allocatable - sum(usage)."""

    def __init__(
        self,
        server,
        node_name: str,
        memory_threshold_bytes: int = 100 << 20,  # evict when avail < 100Mi
        usage_fn: Optional[Callable[[v1.Pod], int]] = None,
        grace_period_s: float = 0.0,
    ):
        self.server = server
        self.node_name = node_name
        self.threshold = memory_threshold_bytes
        self.usage_fn = usage_fn or self._requested_memory
        self.grace_period_s = grace_period_s
        self.evictions = 0  # counter (tests/metrics)
        self._pressure_since: Optional[float] = None

    @staticmethod
    def _requested_memory(pod: v1.Pod) -> int:
        req = v1.compute_pod_resource_request(pod)
        return int(req.get(MEMORY, 0))

    def _node_pods(self) -> List[v1.Pod]:
        pods, _ = self.server.list("pods")
        return [
            p
            for p in pods
            if p.spec.node_name == self.node_name
            and p.status.phase not in (v1.POD_SUCCEEDED, v1.POD_FAILED)
            and p.metadata.deletion_timestamp is None
        ]

    def _allocatable_memory(self) -> int:
        try:
            node = self.server.get("nodes", "", self.node_name)
        except NotFound:
            return 0
        return int(parse_quantity(node.status.allocatable.get("memory", 0)))

    def synchronize(self) -> List[str]:
        """One manager pass (eviction_manager.go synchronize): measure,
        set/clear the pressure condition+taint, evict at most ONE victim
        per pass (the reference's one-eviction-per-interval pacing).
        Returns evicted pod keys."""
        pods = self._node_pods()
        used = {p.metadata.key: self.usage_fn(p) for p in pods}
        available = self._allocatable_memory() - sum(used.values())
        under_pressure = available < self.threshold
        now = time.monotonic()
        if under_pressure and self._pressure_since is None:
            self._pressure_since = now
        if not under_pressure:
            self._pressure_since = None
        self._set_pressure(under_pressure)
        if not under_pressure:
            return []
        if now - self._pressure_since < self.grace_period_s:
            return []
        victims = self._rank(pods, used)
        if not victims:
            return []
        victim = victims[0]
        self._evict(victim, available)
        return [victim.metadata.key]

    def _rank(self, pods: List[v1.Pod], used) -> List[v1.Pod]:
        """rankMemoryPressure: (exceeds-requests, qos, priority, usage).
        BestEffort always "exceeds" (request 0); Guaranteed within its
        requests ranks last with critical priorities."""

        def key(p: v1.Pod):
            req = int(
                v1.compute_pod_resource_request(p).get(MEMORY, 0)
            )
            u = used.get(p.metadata.key, 0)
            exceeds = u > req or qos_class(p) == QOS_BEST_EFFORT
            return (
                not exceeds,  # exceeders first
                p.priority,  # lower priority first
                -u,  # biggest usage first
            )

        return sorted(pods, key=key)

    def _evict(self, pod: v1.Pod, available: int) -> None:
        self.evictions += 1
        logger.warning(
            "evicting %s: node %s available memory %d < threshold %d",
            pod.metadata.key,
            self.node_name,
            available,
            self.threshold,
        )

        def mutate(p):
            p.status.phase = v1.POD_FAILED
            p.status.reason = "Evicted"
            p.status.message = (
                "The node was low on resource: memory. "
                f"Available: {available}, threshold: {self.threshold}."
            )
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("evict")

    def _set_pressure(self, pressure: bool) -> None:
        status = "True" if pressure else "False"

        def mutate(node):
            changed = False
            for c in node.status.conditions:
                if c.type == COND_MEMORY_PRESSURE:
                    if c.status != status:
                        c.status = status
                        c.last_transition_time = time.time()
                        changed = True
                    break
            else:
                node.status.conditions.append(
                    v1.NodeCondition(type=COND_MEMORY_PRESSURE, status=status)
                )
                changed = True
            has_taint = any(
                t.key == MEMORY_PRESSURE_TAINT for t in node.spec.taints
            )
            if pressure and not has_taint:
                node.spec.taints = list(node.spec.taints) + [
                    v1.Taint(MEMORY_PRESSURE_TAINT, "", v1.TAINT_NO_SCHEDULE)
                ]
                changed = True
            elif not pressure and has_taint:
                node.spec.taints = [
                    t
                    for t in node.spec.taints
                    if t.key != MEMORY_PRESSURE_TAINT
                ]
                changed = True
            return node if changed else None

        try:
            self.server.guaranteed_update("nodes", "", self.node_name, mutate)
        except (NotFound, Conflict):
            pass
        except DegradedWrites:
            skip_degraded_write("memory_pressure")
