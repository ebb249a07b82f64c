"""Node lifecycle controller: heartbeat monitoring, taints, eviction.

Reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go
(:314-368): watch node Leases + NodeStatus; a node whose lease outages
exceed nodeMonitorGracePeriod goes NotReady and gets the
node.kubernetes.io/unreachable:NoExecute taint; pods on it are evicted
(deleted) after podEvictionTimeout. Recovery removes the taint.

Eviction-storm safeguards (the reference's zone-aware RateLimitedTimedQueue
+ partial-disruption handling, node_lifecycle_controller.go:1090
handleDisruption):

  * **rate-limited evictions**: node evictions drain through a token
    bucket (evictionLimiterQPS) — a backlog of dead nodes empties at a
    bounded rate instead of as one delete storm.
  * **partial-disruption halt**: when more than ``partial_disruption_
    threshold`` of the lease-managed nodes go unhealthy in one monitor
    pass, the likely cause is a control-plane outage (store degraded /
    partition), not mass node death — evictions HALT and NotReady
    writes back off until the fraction recovers. ``since`` timestamps
    keep accruing, so genuinely dead nodes evict (rate-limited)
    promptly after the halt lifts.
  * **degraded-store tolerance**: ready/taint writes and evictions that
    503 retryably are counted and skipped — the monitor pass never dies
    on a read-only store, and reads (list/lease checks) keep working.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Iterable, List, Tuple

from ..api import objects as v1
from ..client.apiserver import NotFound, NotPrimary
from ..kubemark.hollow_node import NODE_LEASE_NS
from ..runtime.consensus import DegradedWrites
from ..utils.metrics import metrics
from .evictionbudget import EvictionBudget

logger = logging.getLogger("kubernetes_tpu.controller.nodelifecycle")

TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
# applied at node CREATE by the TaintNodesByCondition admission plugin
# (apiserver/admission.py); this controller lifts it once the node is
# Ready and re-applies it while NotReady (nodetaint/admission.go pairs
# with the lifecycle controller's taint reconciliation the same way)
TAINT_NOT_READY = "node.kubernetes.io/not-ready"

# metrics (rendered by /metrics and the SIGUSR2 debugger dump)
GAUGE_PARTIAL_DISRUPTION = "node_lifecycle_partial_disruption"  # 1 = halted
GAUGE_UNHEALTHY_FRACTION = "node_lifecycle_unhealthy_fraction"
GAUGE_EVICTION_TOKENS = "node_lifecycle_eviction_tokens"
COUNTER_EVICTIONS = "node_lifecycle_evictions_total"
COUNTER_EVICTIONS_DEFERRED = "node_lifecycle_evictions_deferred_total"
COUNTER_READY_WRITES_DEFERRED = "node_lifecycle_ready_writes_deferred_total"
COUNTER_STORE_WRITE_FAILURES = "node_lifecycle_store_write_failures_total"


class EvictionLimiter(EvictionBudget):
    """Back-compat alias for the PR-3 token bucket, now extracted into
    controller/evictionbudget.EvictionBudget so the node lifecycle
    controller, the scheduler's preemption victim deletes, and the
    descheduler can spend ONE shared budget (three private buckets would
    let a combined storm triple the configured eviction rate)."""


class NodeLifecycleController:
    def __init__(
        self,
        server,
        node_monitor_period: float = 1.0,
        node_monitor_grace_period: float = 40.0,
        pod_eviction_timeout: float = 60.0,
        eviction_limiter_qps: float = 10.0,
        eviction_limiter_burst: int = 5,
        partial_disruption_threshold: float = 0.55,
        eviction_budget: EvictionBudget = None,
    ):
        self.server = server
        self.monitor_period = node_monitor_period
        self.grace_period = node_monitor_grace_period
        self.eviction_timeout = pod_eviction_timeout
        self.partial_disruption_threshold = partial_disruption_threshold
        # eviction_budget: a process-wide shared bucket (injected by the
        # process wiring when preemption/descheduler coexist); the
        # private-limiter default preserves standalone behavior
        self.limiter = eviction_budget or EvictionLimiter(
            eviction_limiter_qps, eviction_limiter_burst
        )
        self._not_ready_since: Dict[str, float] = {}
        self._storm = False  # partial-disruption mode (evictions halted)
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="nodelifecycle", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._monitor_once()
            except Exception:
                logger.exception("node monitor pass failed")
            self._stop.wait(self.monitor_period)

    def _monitor_once(self) -> None:
        now = time.time()
        nodes, _ = self.server.list("nodes")
        # ONE lease list per pass (was a get per node): the health verdicts
        # for the whole fleet come from one consistent read
        leases, _ = self.server.list("leases", NODE_LEASE_NS)
        lease_by_name = {l.metadata.name: l for l in leases}
        health: List[Tuple[v1.Node, bool]] = []
        managed = unhealthy = 0
        for node in nodes:
            lease = lease_by_name.get(node.metadata.name)
            if lease is None:
                healthy = True  # no lease: not lease-managed (static node)
            else:
                managed += 1
                healthy = now - lease.renew_time < self.grace_period
                if not healthy:
                    unhealthy += 1
            health.append((node, healthy))
        frac = unhealthy / managed if managed else 0.0
        # partial disruption: most of the lease-managed fleet went dark at
        # once — that is a control-plane outage signature (store degraded,
        # partition, heartbeat path down), not mass node death. Tainting
        # and evicting now would amplify the outage into a workload
        # massacre; halt instead and let `since` accrue.
        storm = managed >= 2 and frac > self.partial_disruption_threshold
        if storm != self._storm:
            logger.warning(
                "partial-disruption mode %s (%d/%d lease-managed nodes "
                "unhealthy, threshold %.0f%%): evictions %s",
                "ENTERED" if storm else "LIFTED",
                unhealthy, managed,
                self.partial_disruption_threshold * 100,
                "halted, ready-state writes backing off" if storm
                else "resume (rate-limited)",
            )
        self._storm = storm
        metrics.set_gauge(GAUGE_PARTIAL_DISRUPTION, 1.0 if storm else 0.0)
        metrics.set_gauge(GAUGE_UNHEALTHY_FRACTION, frac)
        pods_by_node = None  # ONE pod list per pass, shared across nodes
        for node, healthy in health:
            name = node.metadata.name
            if healthy:
                # also covers a NEW node healthy from its first pass: it
                # carries the admission-time not-ready taint that only the
                # ready reconcile below lifts
                if name in self._not_ready_since or any(
                    t.key == TAINT_NOT_READY for t in node.spec.taints
                ):
                    self._not_ready_since.pop(name, None)
                    self._set_ready(name, True)
                continue
            since = self._not_ready_since.setdefault(name, now)
            if storm:
                metrics.inc(COUNTER_READY_WRITES_DEFERRED)
                continue
            if now - since >= 0:
                self._set_ready(name, False)
            if now - since > self.eviction_timeout:
                if pods_by_node is None:
                    pods_by_node = self._pods_by_node()
                # toleration filtering BEFORE token acquisition: a node
                # whose pods all tolerate the taint must not burn the
                # budget of nodes with real victims, pass after pass
                victims = [
                    p
                    for p in pods_by_node.get(name, ())
                    if self._evictable(p, since, now)
                ]
                if not victims:
                    continue
                if not self.limiter.try_acquire(actor="nodelifecycle"):
                    metrics.inc(COUNTER_EVICTIONS_DEFERRED)
                    continue
                self._evict_pods(name, victims)
        metrics.set_gauge(GAUGE_EVICTION_TOKENS, self.limiter.tokens)

    def _pods_by_node(self) -> Dict[str, List[v1.Pod]]:
        pods, _ = self.server.list("pods")
        out: Dict[str, List[v1.Pod]] = {}
        for pod in pods:
            if pod.spec.node_name:
                out.setdefault(pod.spec.node_name, []).append(pod)
        return out

    def _set_ready(self, name: str, ready: bool) -> None:
        def mutate(node):
            changed = False
            cond = next(
                (c for c in node.status.conditions if c.type == v1.NODE_READY),
                None,
            )
            want = "True" if ready else "Unknown"
            if cond is None:
                node.status.conditions.append(
                    v1.NodeCondition(
                        type=v1.NODE_READY,
                        status=want,
                        last_transition_time=time.time(),
                    )
                )
                changed = True
            elif cond.status != want:
                cond.status = want
                cond.last_transition_time = time.time()
                changed = True
            has_taint = any(
                t.key == TAINT_UNREACHABLE for t in node.spec.taints
            )
            has_nr_taint = any(
                t.key == TAINT_NOT_READY for t in node.spec.taints
            )
            if ready and (has_taint or has_nr_taint):
                node.spec.taints = [
                    t
                    for t in node.spec.taints
                    if t.key not in (TAINT_UNREACHABLE, TAINT_NOT_READY)
                ]
                changed = True
            elif not ready:
                if not has_taint:
                    node.spec.taints.append(
                        v1.Taint(TAINT_UNREACHABLE, "", v1.TAINT_NO_EXECUTE)
                    )
                    changed = True
                if not has_nr_taint:
                    node.spec.taints.append(
                        v1.Taint(TAINT_NOT_READY, "", v1.TAINT_NO_SCHEDULE)
                    )
                    changed = True
            return node if changed else None

        try:
            self.server.guaranteed_update("nodes", "", name, mutate)
        except NotFound:
            pass
        except (DegradedWrites, NotPrimary):
            # read-only store: the write retries next monitor pass
            metrics.inc(COUNTER_STORE_WRITE_FAILURES)

    @staticmethod
    def _evictable(pod: v1.Pod, since: float, now: float) -> bool:
        """NoExecute toleration semantics (TaintBasedEvictions) against
        the taint this controller actually applies: an unbounded MATCHING
        toleration (incl. the wildcard key=""+Exists DaemonSet form, via
        Toleration.tolerates) exempts the pod; bounded tolerationSeconds
        (e.g. DefaultTolerationSeconds 300s) only DELAY eviction — the
        reference's minTolerationTime: the SHORTEST bound wins."""
        taint = v1.Taint(TAINT_UNREACHABLE, "", v1.TAINT_NO_EXECUTE)
        matching = [t for t in pod.spec.tolerations if t.tolerates(taint)]
        if any(t.toleration_seconds is None for t in matching):
            return False
        if matching and now - since < min(
            t.toleration_seconds for t in matching
        ):
            return False
        return True

    def _evict_pods(self, node_name: str, pods: Iterable[v1.Pod]) -> None:
        for pod in pods:
            try:
                self.server.delete(
                    "pods", pod.metadata.namespace, pod.metadata.name
                )
                metrics.inc(COUNTER_EVICTIONS)
                logger.info(
                    "evicted pod %s from dead node %s",
                    pod.metadata.key,
                    node_name,
                )
            except NotFound:
                pass
            except (DegradedWrites, NotPrimary):
                metrics.inc(COUNTER_STORE_WRITE_FAILURES)
                return  # store read-only: stop the sweep, retry next pass
