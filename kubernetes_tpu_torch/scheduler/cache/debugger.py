"""Cache debugger: on-signal dump + cache-vs-informer consistency compare.

Reference: pkg/scheduler/internal/cache/debugger/{debugger.go:57,
comparer.go, dumper.go, signal.go:25} — SIGUSR2 triggers (a) a dump of the
cached NodeInfos and queued pods, (b) a comparison of the scheduler cache
against informer ground truth. The TPU build adds a third check: the host
columnar mirror against what the device snapshot was built from (a
host/device divergence here means the kernel is scheduling against stale
state).
"""

from __future__ import annotations

import logging
import signal
from typing import List, Tuple

logger = logging.getLogger("kubernetes_tpu.scheduler.debugger")


class CacheDebugger:
    def __init__(self, scheduler):
        self.sched = scheduler

    # -- comparer (comparer.go) ---------------------------------------------

    def compare(self) -> Tuple[List[str], List[str]]:
        """(missed, redundant) node/pod keys: cache vs informer truth."""
        problems_nodes: List[str] = []
        problems_pods: List[str] = []
        informers = self.sched.informer_factory
        node_keys = {
            n.metadata.name for n in informers.informer("nodes").indexer.list()
        }
        cache = self.sched.cache
        with cache.lock:
            cached_nodes = set(cache._nodes.keys())
            cached_pods = set(cache._pod_to_node.keys())
        missed = node_keys - cached_nodes
        redundant = cached_nodes - node_keys
        if missed:
            problems_nodes.append(f"cache missing nodes: {sorted(missed)}")
        if redundant:
            problems_nodes.append(f"cache has extra nodes: {sorted(redundant)}")

        scheduled_pod_keys = {
            p.metadata.key
            for p in informers.informer("pods").indexer.list()
            if p.spec.node_name
        }
        missed_p = scheduled_pod_keys - cached_pods
        redundant_p = cached_pods - scheduled_pod_keys
        # assumed-but-unbound pods are legitimately cache-only
        with cache.lock:
            assumed = set(cache._assumed.keys())
        redundant_p -= assumed
        if missed_p:
            problems_pods.append(f"cache missing pods: {sorted(missed_p)}")
        if redundant_p:
            problems_pods.append(f"cache has extra pods: {sorted(redundant_p)}")
        return problems_nodes, problems_pods

    # -- dumper (dumper.go) --------------------------------------------------

    def dump(self) -> str:
        cache = self.sched.cache
        queue = self.sched.queue
        lines = ["Dump of cached NodeInfo:"]
        with cache.lock:
            for name in sorted(cache._nodes):
                ni = cache._nodes[name]
                lines.append(f"  node {name}: {len(ni.pods)} pods")
        lines.append("Dump of scheduling queue:")
        for section, keys in queue.pending_pods().items():
            lines.append(f"  {section}: {keys}")
        rt = getattr(self.sched, "_ridethrough", None)
        if rt is not None:
            lines.append("Dump of degraded-store ride-through state:")
            for k, v in rt.state().items():
                lines.append(f"  {k}: {v}")
        repl = replication_health_lines()
        if repl:
            lines.append("Dump of API-store replication/consensus state:")
            lines.extend(repl)
        ride = ridethrough_health_lines()
        if ride:
            lines.append("Dump of control-plane ride-through gauges:")
            lines.extend(ride)
        from ..antientropy import dataplane_health_lines

        # refresh the retire-stall watchdog before rendering: a leaked
        # reader pin must show up in THIS dump even if no lease traffic
        # (and no audit pass) has run since the generation was superseded
        enc = getattr(cache, "encoder", None)
        if enc is not None:
            enc.check_retire_stalls()
        plane = dataplane_health_lines()
        if plane:
            lines.append("Dump of data-plane self-defense state:")
            lines.extend(plane)
        from ...autoscaler.controller import autoscaler_health_lines

        auto = autoscaler_health_lines()
        if auto:
            lines.append("Dump of cluster-autoscaler state:")
            lines.extend(auto)
        from ...controller.evictionbudget import eviction_budget_health_lines
        from ...descheduler.controller import descheduler_health_lines

        defrag = descheduler_health_lines() + eviction_budget_health_lines()
        if defrag:
            lines.append(
                "Dump of descheduler / shared eviction-budget state:"
            )
            lines.extend(defrag)
        from ...apiserver.cacher import readpath_health_lines

        readpath = readpath_health_lines()
        if readpath:
            lines.append("Dump of read-path (watch cache / flow control) state:")
            lines.extend(readpath)
        from ...apiserver.client import serving_health_lines
        from ...apiserver.frontend import frontend_health_lines

        serving = serving_health_lines() + frontend_health_lines()
        if serving:
            lines.append(
                "Dump of serving-tier (REST connection pool / follower "
                "read) state:"
            )
            lines.extend(serving)
        from ...relay import relay_health_lines

        relay = relay_health_lines()
        if relay:
            lines.append(
                "Dump of serving-relay (shared-memory frame ring / "
                "fan-out worker) state:"
            )
            lines.extend(relay)
        from ..preemption import preemption_health_lines

        preempt = preemption_health_lines()
        if preempt:
            lines.append("Dump of priority/preemption engine state:")
            lines.extend(preempt)
        from ..ha import ha_health_lines

        ha = ha_health_lines()
        if ha:
            lines.append(
                "Dump of scheduler-HA / leader-election state "
                f"(this replica: {getattr(self.sched, '_ha_identity', '?')}):"
            )
            lines.extend(ha)
        from ...tuner.policy import tuner_health_lines

        tuner = tuner_health_lines()
        if tuner:
            lines.append("Dump of policy-gym (self-tuning scheduler) state:")
            lines.extend(tuner)
        disk = disk_health_lines()
        if disk:
            lines.append("Dump of WAL / disk-fault state:")
            lines.extend(disk)
        from ...utils import tracing as tracing_mod

        lines.append("Dump of per-pod scheduling traces (slowest first):")
        lines.extend(tracing_mod.tracer.render_lines(8))
        trc = tracing_mod.health_lines()
        if trc:
            lines.append("Dump of tracing pipeline state:")
            lines.extend(trc)
        return "\n".join(lines)

    # -- signal hookup (signal.go:25) ---------------------------------------

    def listen_for_signal(self, signum: int = signal.SIGUSR2) -> None:
        def handler(_sig, _frame):
            logger.info(self.dump())
            nodes, pods = self.compare()
            for p in nodes + pods:
                logger.warning("cache comparison: %s", p)
            if not nodes and not pods:
                logger.info("cache comparison: consistent with informers")

        signal.signal(signum, handler)


def replication_health_lines() -> List[str]:
    """The consensus/replication gauges (runtime/consensus.py publishes
    commit_index, quorum_state, per-follower lag under ``apiserver_``)
    rendered for the SIGUSR2 dump: a wedged cluster — writes 503ing,
    followers lagging, quorum lost — is diagnosable from one signal with
    no log access. Empty when this process runs no replicated store."""
    from ...utils.metrics import metrics

    lines: List[str] = []
    for name, labels, value in metrics.snapshot_gauges("apiserver_"):
        annotation = ""
        if name == "apiserver_quorum_state":
            annotation = "healthy" if value else "DEGRADED (writes 503)"
        lines.append(
            metrics.format_series_line(name, labels, value, annotation)
        )
    return lines


def ridethrough_health_lines() -> List[str]:
    """The degraded-mode ride-through gauges — pending-bind buffer depth
    and breaker state (scheduler/ridethrough.py), eviction-limiter and
    partial-disruption state (controller/nodelifecycle.py) — rendered for
    the SIGUSR2 dump so a paused pipeline is diagnosable from one signal.
    Empty when none of those components has published state yet."""
    from ...utils.metrics import metrics

    lines: List[str] = []
    for prefix in ("scheduler_pending_binds", "scheduler_bind_breaker",
                   "node_lifecycle_"):
        for name, labels, value in metrics.snapshot_gauges(prefix):
            annotation = ""
            if name == "scheduler_bind_breaker_state":
                annotation = "OPEN (dispatch paused)" if value else "closed"
            elif name == "node_lifecycle_partial_disruption":
                annotation = (
                    "HALTED (evictions paused)" if value else "normal"
                )
            lines.append(
                metrics.format_series_line(name, labels, value, annotation)
            )
    return lines


def disk_health_lines() -> List[str]:
    """The durability gauges and counters (runtime/wal.py publishes sink
    fail-stop / fsync-stall / corruption state under ``wal_``, the store
    publishes its disk read-only state and free-space probe under
    ``store_disk_``) rendered for the SIGUSR2 dump: a store that went
    read-only for disk reasons — failed sink, ENOSPC, corrupt recovery —
    is diagnosable from one signal with no log access. Empty when this
    process runs no WAL-backed store."""
    from ...utils.metrics import metrics

    lines: List[str] = []
    for prefix in ("wal_", "store_disk_"):
        for name, labels, value in metrics.snapshot_gauges(prefix):
            annotation = ""
            if name == "wal_sink_failed":
                annotation = (
                    "FAIL-STOPPED (writes 503 until failover)"
                    if value else "healthy"
                )
            elif name == "store_disk_state":
                annotation = {
                    0.0: "ok",
                    1.0: "DISK PRESSURE (read-only, auto-reopens)",
                    2.0: "DISK FAILED (read-only, permanent)",
                }.get(value, "?")
            elif name in ("wal_recovered_corrupt", "store_disk_corrupt"):
                annotation = (
                    "CORRUPT (refusing promotion until resynced)"
                    if value else "clean"
                )
            elif name == "wal_fsync_stalled":
                annotation = "STALLED" if value else "ok"
            lines.append(
                metrics.format_series_line(name, labels, value, annotation)
            )
        for name, labels, value in metrics.snapshot_counters(prefix):
            lines.append(metrics.format_series_line(name, labels, value, ""))
    return lines


def audit_device_vs_masters(enc, dev, masters, fields=("requested", "sel_counts", "port_counts")):
    """Compare a fetched device snapshot against the host masters and print
    row/column/value diagnostics for every differing field. Shared by the
    soak driver and the mismatch reproducer so their reports can't drift.
    Returns the list of differing field names. Caller holds the cache lock
    (the row_names/_pods reads must be consistent with the arrays)."""
    import numpy as np

    bad = []
    for f in fields:
        d = np.asarray(getattr(dev, f))
        m = np.asarray(getattr(masters, f))
        if np.array_equal(d, m):
            continue
        bad.append(f)
        rows = sorted(set(np.nonzero(d != m)[0].tolist()))
        print(f"AUDIT {f}: {len(rows)} rows differ", flush=True)
        for r in rows[:4]:
            if d[r].ndim:
                cols = np.nonzero(d[r] != m[r])[0]
                dv, mv = d[r][cols[:8]].tolist(), m[r][cols[:8]].tolist()
                cshow = cols[:8].tolist()
            else:
                cshow, dv, mv = "-", d[r], m[r]
            print(
                f"  row={r} node={enc.row_names[r] if r < len(enc.row_names) else '?'} "
                f"cols={cshow} dev={dv} mst={mv} "
                f"host_pods={len(enc._pods.get(r, {}))}",
                flush=True,
            )
    return bad
