"""Descheduler controller: the periodic loop around planner + executor.

Shape mirrors the ClusterAutoscaler loop (autoscaler/controller.py) —
own daemon thread, one `run_once` pass per period, every failure logged
and survived. Per pass:

  1. **Fence** — re-read the leadership lease (scheduler.check_eviction_
     fence). A fenced replica writes NOTHING this pass, not even orphan
     uncordons: those belong to the new leader's sweep.
  2. **Sweep** — uncordon nodes still carrying our defrag annotation
     that no active plan claims (rollback retries after a degraded
     store, and cordons orphaned by a crash or leadership change).
  3. **Observe** — publish the fleet fragmentation score (the
     scheduler's gauge, re-exported under the descheduler family so one
     SIGUSR2 dump shows signal next to actuation).
  4. **Act** — if a plan is latched, run one executor tick. Otherwise,
     plan: but ONLY when the unschedulable backlog is empty (freed
     capacity belongs to pending pods; consolidating while pods queue
     would evict bound work to seat queued work — the priority-band
     inversion the ISSUE forbids) and fragmentation clears the floor.

The descheduler follows scheduler leadership: cmd/scheduler.py starts it
in on_started and stops it in on_stopped, and every pass re-checks the
lease anyway (belt and suspenders — the stop() call from a lost lease
races the in-flight pass).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from ..utils.metrics import metrics
from .executor import PlanExecutor
from .planner import COUNTER_PLAN_REJECTED, plan_consolidation

logger = logging.getLogger("kubernetes_tpu.descheduler")

GAUGE_FRAGMENTATION = "descheduler_fragmentation_score"
GAUGE_ACTIVE_PLAN_NODES = "descheduler_active_plan_nodes"
COUNTER_PLANS = "descheduler_plans_total"
COUNTER_FENCED_PASSES = "descheduler_fenced_passes_total"


class Descheduler:
    def __init__(
        self,
        server,
        scheduler,
        eviction_budget,
        catalog=None,
        period_s: float = 1.0,
        util_threshold: float = 0.5,
        fragmentation_floor: float = 0.0,
        max_nodes_per_plan: int = 2,
        max_victim_priority: int = 1_000_000_000,
        cost_aware: bool = True,
    ):
        from ..autoscaler.planner import WhatIfSimulator
        from ..client.apiserver import LeaderFenced

        self._LeaderFenced = LeaderFenced
        self.server = server
        self.scheduler = scheduler
        self.period = period_s
        self.util_threshold = util_threshold
        # plans are only attempted when fragmentation exceeds this floor:
        # 0.0 means "any stranded capacity is worth a what-if pass"
        self.fragmentation_floor = fragmentation_floor
        self.max_nodes_per_plan = max_nodes_per_plan
        self.max_victim_priority = max_victim_priority
        self.sim = WhatIfSimulator(
            scheduler.cache,
            hard_pod_affinity_weight=scheduler.cfg.hard_pod_affinity_weight,
            cost_aware=cost_aware,
        )
        self.executor = PlanExecutor(
            server, scheduler, self.sim, eviction_budget, catalog=catalog
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()  # restartable across leadership cycles
        self._thread = threading.Thread(
            target=self._run, name="descheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                logger.exception("descheduler pass failed")
            self._stop.wait(self.period)

    # -- one pass ------------------------------------------------------------

    def run_once(self) -> None:
        # fence before ANY write this pass — sweep() uncordons are writes
        try:
            self.scheduler.check_eviction_fence()
        except self._LeaderFenced:
            metrics.inc(COUNTER_FENCED_PASSES)
            if self.executor.active:
                self.executor.tick()  # tick re-checks and aborts fenced
            return
        try:
            nodes, _ = self.server.list("nodes")
        except Exception:
            logger.exception("node list failed; skipping descheduler pass")
            return
        self.executor.sweep(nodes)

        frag = self.scheduler.fragmentation_score()
        metrics.set_gauge(GAUGE_FRAGMENTATION, frag)

        if self.executor.active:
            self.executor.tick()
        else:
            self._maybe_plan(frag)
        plan = self.executor.plan
        metrics.set_gauge(
            GAUGE_ACTIVE_PLAN_NODES,
            float(len(plan.nodes)) if plan is not None else 0.0,
        )

    def _maybe_plan(self, frag: float) -> None:
        backlog = [
            pi
            for pi in self.scheduler.queue.unschedulable_pod_infos()
            if pi.pod.metadata.deletion_timestamp is None
        ]
        if backlog:
            # pending pods own the free capacity: consolidating now would
            # evict bound (possibly higher-priority) work to make room
            # for queued work — defer until the backlog drains
            metrics.inc(COUNTER_PLAN_REJECTED, {"reason": "pending_backlog"})
            return
        if frag <= self.fragmentation_floor:
            return
        plan, reason = plan_consolidation(
            self.sim,
            self.scheduler.cache,
            util_threshold=self.util_threshold,
            max_nodes_per_plan=self.max_nodes_per_plan,
            max_victim_priority=self.max_victim_priority,
        )
        if plan is None:
            logger.debug("no consolidation plan: %s", reason)
            return
        metrics.inc(COUNTER_PLANS)
        self.executor.adopt(plan)
        self.executor.tick()  # first wave in the same pass


def descheduler_health_lines() -> List[str]:
    """Descheduler + shared eviction-budget series rendered for the
    SIGUSR2 debugger dump (scheduler/cache/debugger.py): a stuck plan, a
    paused wave, or a starved budget is diagnosable from one signal.
    Empty when no descheduler has published state in this process."""
    lines: List[str] = []
    for series in (
        metrics.snapshot_gauges("descheduler_"),
        metrics.snapshot_counters("descheduler_"),
    ):
        for name, labels, value in series:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines
