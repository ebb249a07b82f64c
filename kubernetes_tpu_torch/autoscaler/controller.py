"""Cluster autoscaler controller: the loop around the what-if planner.

Reference shape: the cluster-autoscaler's RunOnce loop (core/static_
autoscaler.go) — scale-up from pending pods, scale-down from sustained
underutilization — with the decision engine swapped for batched kernel
what-if passes (planner.py) so capacity decisions use the SAME constraint
machinery as placement.

Per pass:
  1. **Scale-up**: snapshot the scheduler's unschedulableQ; if pods are
     pending (and no prior provisioning is still registering), run one
     overlay kernel pass over real + virtual rows and create exactly the
     Node objects the kernel used, through the apiserver. Hollow-node
     kubelets (kubemark) pick them up via the NodeGroup provision hook;
     the node-add informer event flushes unschedulableQ (failure-relative
     backoff — queue satellite), so pending pods bind within one period.
  2. **Scale-down**: nodes of a group, under the utilization threshold for
     `scale_down_unneeded_passes` consecutive passes, are drain-simulated
     (that node's row masked out). Only a PASSING simulation cordons; the
     drain then flows through the eviction token bucket (the PR-3
     limiter), re-verifying the simulation each pass, and the empty node
     is deleted + deprovisioned. A failing simulation never evicts
     anything (zero-eviction guarantee).

Degraded-store tolerance (PR-1/PR-3 discipline): every write that 503s
retryably is counted and skipped; the pass never dies on a read-only
store, and cordoned-but-undrained nodes resume next pass.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set

from ..api import objects as v1
from ..api.objects import ANN_SAFE_TO_EVICT, LABEL_NODEGROUP
from ..api.resources import CPU, MEMORY, PODS
from ..client.apiserver import NotFound, NotPrimary
from ..controller.nodelifecycle import EvictionLimiter
from ..runtime.consensus import DegradedWrites
from ..utils.metrics import metrics
from .nodegroups import NodeGroup, NodeGroupCatalog
from .planner import (
    HIST_SIMULATION,
    WhatIfSimulator,
    plan_scale_up,
    simulate_drain,
)

logger = logging.getLogger("kubernetes_tpu.autoscaler")

GAUGE_PENDING = "autoscaler_pending_pods"
GAUGE_PROVISIONING = "autoscaler_provisioning_nodes"
GAUGE_DRAINING = "autoscaler_draining_nodes"
COUNTER_PROVISIONED = "autoscaler_nodes_provisioned_total"
COUNTER_REMOVED = "autoscaler_nodes_removed_total"
COUNTER_EVICTIONS = "autoscaler_evictions_total"
COUNTER_BLOCKED = "autoscaler_scale_down_blocked_total"
COUNTER_STORE_SKIPS = "autoscaler_degraded_write_skips_total"
COUNTER_UNPLACED = "autoscaler_unplaced_pods_total"
COUNTER_TRUNCATED = "autoscaler_truncated_pods_total"
# heterogeneity/cost observability: per-shape catalog price and the live
# fleet's aggregate cost-per-hour (the hetero bench's acceptance metric —
# cheapest-feasible-shape packing must show up as a strictly cheaper fleet)
GAUGE_SHAPE_COST = "autoscaler_shape_cost_per_hour"
GAUGE_SHAPE_COST_FLEET = "autoscaler_shape_cost_fleet_per_hour"

# stamped alongside the cordon so a restarted autoscaler can tell ITS
# drains from operator cordons: the in-memory _draining set dies with the
# process, and an unschedulable node it no longer recognizes would
# otherwise leak (never drained, never deleted, never uncordoned)
ANN_SCALE_DOWN = "autoscaler.kubernetes-tpu.io/scale-down"


class ClusterAutoscaler:
    def __init__(
        self,
        server,
        scheduler,
        catalog: NodeGroupCatalog,
        period_s: float = 1.0,
        max_provision_per_cycle: int = 16,
        scale_down_enabled: bool = True,
        scale_down_util_threshold: float = 0.3,
        scale_down_unneeded_passes: int = 3,
        eviction_qps: float = 10.0,
        eviction_burst: int = 5,
        provision_register_timeout_s: float = 30.0,
        cost_aware: bool = True,
        eviction_budget=None,
    ):
        self.server = server
        self.scheduler = scheduler
        self.catalog = catalog
        self.period = period_s
        self.max_per_cycle = max_provision_per_cycle
        self.scale_down_enabled = scale_down_enabled
        self.util_threshold = scale_down_util_threshold
        self.unneeded_passes = scale_down_unneeded_passes
        self.register_timeout = provision_register_timeout_s
        # eviction_budget: the process-wide shared bucket (controller/
        # evictionbudget.py) when this process also runs nodelifecycle /
        # preemption / the descheduler; private bucket otherwise
        self.limiter = eviction_budget or EvictionLimiter(
            eviction_qps, eviction_burst
        )
        self.sim = WhatIfSimulator(
            scheduler.cache,
            hard_pod_affinity_weight=scheduler.cfg.hard_pod_affinity_weight,
            cost_aware=cost_aware,
        )
        # shape economics: each group's cost-per-hour published once (the
        # fleet gauge tracks the live bill each pass, run_once)
        self._group_cost = {g.name: g.cost_per_hour() for g in catalog.groups}
        for g in catalog.groups:
            metrics.set_gauge(
                GAUGE_SHAPE_COST, self._group_cost[g.name], {"group": g.name}
            )
        # provisioned-but-not-yet-registered node names (+ deadline): while
        # non-empty, scale-up pauses — re-simulating against a snapshot
        # that can't see the nodes we JUST added would double-provision
        # for the same pods
        self._provisioning: Dict[str, float] = {}
        self._low_util_streak: Dict[str, int] = {}
        self._draining: Set[str] = set()
        # futility memo: a pass that provisioned NOTHING for this exact
        # pending set against this exact cluster state would re-run the
        # same multi-second simulation every period — skip until either
        # side changes (the encoder generation moves on any cluster
        # mutation, incl. our own provisions registering)
        self._futile: Optional[tuple] = None  # (pod-key frozenset, gen)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()  # restartable (stop() → start() cycles)
        self._thread = threading.Thread(
            target=self._run, name="cluster-autoscaler", daemon=True
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
                logger.exception("autoscaler pass failed")
            self._stop.wait(self.period)

    # -- one pass ------------------------------------------------------------

    def run_once(self) -> None:
        pending = [
            pi.pod
            for pi in self.scheduler.queue.unschedulable_pod_infos()
            if pi.pod.metadata.deletion_timestamp is None
        ]
        metrics.set_gauge(GAUGE_PENDING, float(len(pending)))
        self._reap_registered()
        if pending and not self._provisioning:
            self._scale_up(pending)
        if self.scale_down_enabled:
            self._scale_down_pass()
        metrics.set_gauge(GAUGE_PROVISIONING, float(len(self._provisioning)))
        metrics.set_gauge(GAUGE_DRAINING, float(len(self._draining)))
        # live fleet cost-per-hour from the cache's node set and the
        # catalog's shape prices (unlabeled / out-of-catalog nodes cost 0)
        fleet = 0.0
        try:
            for ni in self.scheduler.cache.node_infos().values():
                if ni.node is None:
                    continue
                gname = ni.node.metadata.labels.get(LABEL_NODEGROUP, "")
                fleet += self._group_cost.get(gname, 0.0)
        except Exception:
            logger.exception("fleet cost gauge pass failed")
        metrics.set_gauge(GAUGE_SHAPE_COST_FLEET, round(fleet, 6))

    def _reap_registered(self) -> None:
        """Drop provisioned nodes once the scheduler cache sees them (the
        snapshot can simulate against them from then on); time out the
        ones that never register so one lost provision can't wedge
        scale-up forever."""
        now = time.monotonic()
        for name, deadline in list(self._provisioning.items()):
            if self.scheduler.cache.get_node_info(name) is not None:
                del self._provisioning[name]
            elif now > deadline:
                logger.warning(
                    "provisioned node %s never registered; giving up", name
                )
                del self._provisioning[name]

    # -- scale-up ------------------------------------------------------------

    def _host_filter(self, pod: v1.Pod, ni) -> bool:
        """Production filter plugins for fallback (encoding-overflow) pods:
        the scheduler's pre-batch-sound subset against a virtual NodeInfo
        — the same plugin objects the live filter chain runs."""

        class _PI:
            __slots__ = ("pod",)

        pi = _PI()
        pi.pod = pod
        try:
            return self.scheduler._check_placement(pi, ni) is None
        except Exception:
            logger.exception("host filter failed for %s", pod.metadata.key)
            return False

    def _scale_up(self, pending: List[v1.Pod]) -> None:
        state = (
            frozenset(p.metadata.key for p in pending),
            self.scheduler.cache.encoder.generation,
        )
        if state == self._futile:
            return
        try:
            nodes, _ = self.server.list("nodes")
        except Exception:
            logger.exception("node list failed; skipping scale-up pass")
            return
        sizes = self.catalog.sizes(nodes)
        live_names = {n.metadata.name for n in nodes}
        plan = plan_scale_up(
            self.sim,
            self.catalog,
            pending,
            sizes,
            live_names,
            max_provision_per_cycle=self.max_per_cycle,
            host_filter=self._host_filter,
        )
        if plan.unplaced:
            metrics.inc(COUNTER_UNPLACED, by=float(plan.unplaced))
        if plan.truncated:
            # pods past the per-pass simulation width: not dropped — they
            # stay queued and the next pass (new cluster state after these
            # provisions register) picks them up — but say so
            metrics.inc(COUNTER_TRUNCATED, by=float(plan.truncated))
            logger.info(
                "scale-up pass simulated %d of %d pending pods "
                "(max_pods_per_pass); the rest plan next pass",
                len(pending) - plan.truncated, len(pending),
            )
        if not plan.total_nodes:
            if plan.skipped:
                logger.debug("scale-up skipped: %s", plan.skipped)
            self._futile = state
            return
        self._futile = None
        deadline = time.monotonic() + self.register_timeout
        for gname, names in plan.nodes.items():
            group = self.catalog.group(gname)
            for name in names:
                try:
                    self._provision_one(group, name)
                except (DegradedWrites, NotPrimary):
                    # read-only store: provisioning resumes when writes
                    # reopen (the pods stay pending, the next pass replans)
                    metrics.inc(COUNTER_STORE_SKIPS, {"write": "provision"})
                    return
                except Exception:
                    logger.exception("provisioning %s/%s failed", gname, name)
                    continue
                self._provisioning[name] = deadline
                metrics.inc(COUNTER_PROVISIONED, {"group": gname})
        logger.info(
            "scale-up: provisioned %d node(s) %s for %d pending pods "
            "(%d placed in simulation, %d unplaced by any shape, "
            "%d nodes over the per-cycle cap deferred)",
            plan.total_nodes, dict(plan.nodes), len(pending), plan.placed,
            plan.unplaced, plan.capped,
        )

    def _provision_one(self, group: NodeGroup, name: str) -> None:  # graftlint: degraded-ok(every call site sits in the scale-up loop's try: DegradedWrites is counted as a store-skip and the slot retries next cycle)
        if group.provision is not None:
            group.provision(name)
        else:
            self.server.create("nodes", group.make_node(name))

    # -- scale-down ----------------------------------------------------------

    def _utilization(self, ni) -> float:
        """max over cpu/mem/pod-count of requested/allocatable — the CA's
        node utilization measure, from the SAME aggregates the kernel's
        resource columns are built from."""
        out = 0.0
        for res in (CPU, MEMORY):
            alloc = ni.allocatable.get(res, 0)
            if alloc > 0:
                out = max(out, ni.requested.get(res, 0) / alloc)
        pod_cap = ni.allocatable.get(PODS, 0)
        if pod_cap > 0:
            out = max(out, len(ni.pods) / pod_cap)
        return out

    def _movable(self, pod: v1.Pod) -> bool:
        """A pod blocks scale-down unless a controller will recreate it
        (owner references — DaemonSet owners included: those pods are
        excluded from drain simulation AND eviction separately, in
        simulate_drain/_drain_one) or it is annotated safe-to-evict."""
        if pod.metadata.owner_references:
            return True
        return (
            pod.metadata.annotations.get(ANN_SAFE_TO_EVICT, "").lower()
            == "true"
        )

    def _scale_down_pass(self) -> None:
        cache = self.scheduler.cache
        try:
            nodes, _ = self.server.list("nodes")
        except Exception:
            logger.exception("node list failed; skipping scale-down pass")
            return
        sizes = self.catalog.sizes(nodes)
        infos = cache.node_infos()  # ONE lock acquisition per pass
        # adopt drains orphaned by a restart/leadership change: OUR cordon
        # annotation on an unschedulable group node we don't remember
        # means a previous incarnation was mid-drain
        for node in nodes:
            if (
                node.spec.unschedulable
                and node.metadata.name not in self._draining
                and node.metadata.annotations.get(ANN_SCALE_DOWN) == "true"
                and self.catalog.group_of_node(node) is not None
            ):
                logger.warning(
                    "adopting orphaned drain of %s (cordoned by a previous "
                    "autoscaler incarnation)", node.metadata.name,
                )
                self._draining.add(node.metadata.name)
        draining_by_group: Dict[str, int] = {}
        by_name = {n.metadata.name: n for n in nodes}
        for d in self._draining:
            dn = by_name.get(d)
            if dn is not None:
                g = dn.metadata.labels.get(LABEL_NODEGROUP, "")
                draining_by_group[g] = draining_by_group.get(g, 0) + 1
        live = set()
        for node in nodes:
            name = node.metadata.name
            live.add(name)
            if name in self._draining:
                continue
            group = self.catalog.group_of_node(node)
            ni = infos.get(name)
            if (
                group is None
                or ni is None
                or name in self._provisioning
                or node.spec.unschedulable
                or sizes.get(group.name, 0)
                - draining_by_group.get(group.name, 0)
                <= group.min_size
            ):
                self._low_util_streak.pop(name, None)
                continue
            if self._utilization(ni) > self.util_threshold:
                self._low_util_streak.pop(name, None)
                continue
            streak = self._low_util_streak.get(name, 0) + 1
            self._low_util_streak[name] = streak
            if streak < self.unneeded_passes:
                continue
            if self._try_cordon(node, ni):
                # count the new drain against the group's min_size floor
                # IMMEDIATELY: two same-pass candidates must not both
                # cordon past the floor (observed overshoot to 1 node
                # with min_size=2 before this)
                draining_by_group[group.name] = (
                    draining_by_group.get(group.name, 0) + 1
                )
        # nodes that vanished under us
        self._draining &= live
        for name in set(self._low_util_streak) - live:
            del self._low_util_streak[name]
        for name in list(self._draining):
            self._drain_one(name)

    def _node_group_name(self, node_name: str) -> str:
        ni = self.scheduler.cache.get_node_info(node_name)
        if ni is None or ni.node is None:
            return ""
        return ni.node.metadata.labels.get(LABEL_NODEGROUP, "")

    def _try_cordon(self, node: v1.Node, ni) -> bool:
        """Returns True iff the node was cordoned (now draining)."""
        name = node.metadata.name
        resident = list(ni.pods)
        unmovable = [p for p in resident if not self._movable(p)]
        if unmovable:
            metrics.inc(COUNTER_BLOCKED, {"reason": "unmovable_pods"})
            self._low_util_streak.pop(name, None)
            return False
        verdict = simulate_drain(self.sim, name, resident)
        if not verdict.ok:
            # the zero-eviction guarantee: a failed what-if means this
            # node is load-bearing — do NOT cordon, do NOT evict
            metrics.inc(COUNTER_BLOCKED, {"reason": "simulation_infeasible"})
            logger.info(
                "scale-down of %s blocked: %s", name, verdict.reason
            )
            self._low_util_streak.pop(name, None)
            return False

        def cordon(n):
            if n.spec.unschedulable:
                return None
            n.spec.unschedulable = True
            n.metadata.annotations[ANN_SCALE_DOWN] = "true"
            return n

        try:
            self.server.guaranteed_update("nodes", "", name, cordon)
        except NotFound:
            return False
        except (DegradedWrites, NotPrimary):
            metrics.inc(COUNTER_STORE_SKIPS, {"write": "cordon"})
            return False
        logger.info(
            "scale-down: cordoned %s (drain simulation re-placed %d pods)",
            name, verdict.replaced,
        )
        self._low_util_streak.pop(name, None)
        self._draining.add(name)
        return True

    def _drain_one(self, name: str) -> None:
        cache = self.scheduler.cache
        ni = cache.get_node_info(name)
        if ni is None:
            self._draining.discard(name)
            return
        victims = [
            p
            for p in ni.pods
            if not any(
                r.kind == "DaemonSet" for r in p.metadata.owner_references
            )
        ]
        if not victims:
            self._delete_node(name)
            return
        # re-verify MOVABILITY before every eviction wave, not just at
        # cordon time: a bare pod that landed after the cordon (in-flight
        # bind, direct node_name create) has nothing to recreate it —
        # deleting it would be permanent workload loss
        unmovable = [p for p in victims if not self._movable(p)]
        if unmovable:
            metrics.inc(COUNTER_BLOCKED, {"reason": "unmovable_pods"})
            logger.warning(
                "drain of %s paused: unmovable pod(s) %s arrived after "
                "the cordon", name,
                [p.metadata.key for p in unmovable],
            )
            return
        # re-verify feasibility too: the cluster may have changed since
        # the cordon, and evicting a pod the CURRENT what-if can't
        # re-place would break the zero-eviction guarantee — pause
        # (cordon stays, nothing evicted) and retry next pass
        verdict = simulate_drain(self.sim, name, victims)
        if not verdict.ok:
            metrics.inc(COUNTER_BLOCKED, {"reason": "drain_paused"})
            logger.warning(
                "drain of %s paused: %s", name, verdict.reason
            )
            return
        for pod in victims:
            if not self.limiter.try_acquire(actor="autoscaler"):
                return  # token bucket dry: resume next pass
            try:
                self.server.delete(
                    "pods", pod.metadata.namespace, pod.metadata.name
                )
                metrics.inc(COUNTER_EVICTIONS)
            except NotFound:
                pass
            except (DegradedWrites, NotPrimary):
                metrics.inc(COUNTER_STORE_SKIPS, {"write": "evict"})
                return

    def _delete_node(self, name: str) -> None:
        group = self.catalog.group(self._node_group_name(name))
        try:
            self.server.delete("nodes", "", name)
        except NotFound:
            pass
        except (DegradedWrites, NotPrimary):
            metrics.inc(COUNTER_STORE_SKIPS, {"write": "node_delete"})
            return
        self._draining.discard(name)
        gname = group.name if group else "unknown"
        if group is not None and group.deprovision is not None:
            try:
                group.deprovision(name)
            except Exception:
                logger.exception("deprovision hook failed for %s", name)
        metrics.inc(COUNTER_REMOVED, {"group": gname})
        logger.info("scale-down: removed empty node %s (group %s)", name, gname)


def autoscaler_health_lines() -> List[str]:
    """Autoscaler gauges/counters + simulation p99 rendered for the
    SIGUSR2 debugger dump (scheduler/cache/debugger.py) — a wedged
    scale-up (pods pending, nodes stuck registering) or a blocked
    scale-down is diagnosable from one signal. Empty when no autoscaler
    has published state in this process."""
    lines: List[str] = []
    for series in (
        metrics.snapshot_gauges("autoscaler_"),
        metrics.snapshot_counters("autoscaler_"),
    ):
        for name, labels, value in series:
            lines.append(metrics.format_series_line(name, labels, value))
    h = metrics.histogram(HIST_SIMULATION)
    if h is not None and h.n:
        p50, p99 = h.quantiles((0.5, 0.99))
        lines.append(
            f"  {HIST_SIMULATION}: n={h.n} p50={p50 * 1e3:.1f}ms "
            f"p99={p99 * 1e3:.1f}ms"
        )
    return lines
