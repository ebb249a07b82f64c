"""tests/test_chaos_preempt.py on the port: the priority/preemption chaos
scenarios through the port's Scheduler on the CPU (device="cpu"), with
the port's APIServer as the ChaosStore bind ledger
(tests/test_torch_autoscaler.py), held to the reference test's own
assertions on the same inputs:

  * **Preemption storm with PDBs**: every burst pod binds, ZERO budget
    violations (no protected pod is ever evicted), ZERO double-evictions
    (each victim uid deleted at most once), and the acked-bind ledger
    stays intact.
  * **Kill-leader mid-preemption**: the scheduler dies after its engine
    already evicted victims; a replacement adopts the cluster from store
    read-back and the burst completes WITHOUT re-evicting (victim deletes
    stay at the minimal count; no pod uid is deleted twice).
  * **Degraded store during preemption**: victim deletes cannot land —
    the attempt aborts as a counted skip (nothing half-evicted), pods
    stay pending, and the storm completes after recovery.

The reference marks the three scenarios slow (its XLA compiles); the
port compiles nothing, they take seconds on the CPU, and they run
unmarked here.
"""

import functools
import threading

from test_torch_autoscaler import ChaosStore, assert_bind_invariants, wait_until

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration
from kubernetes_tpu_torch.scheduler import Scheduler as _Scheduler
from kubernetes_tpu_torch.utils.metrics import metrics

# every Scheduler of these scenarios runs on the CPU
Scheduler = functools.partial(_Scheduler, device="cpu")


def make_node(name, cpu="4"):
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        status=v1.NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": 110}
        ),
    )


def make_pod(name, cpu="1", prio=0, labels=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels or {}),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": cpu})], priority=prio
        ),
    )


def _pdb(name, app, allowed):
    return v1.PodDisruptionBudget(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodDisruptionBudgetSpec(
            min_available=1, selector={"app": app}
        ),
        status=v1.PodDisruptionBudgetStatus(disruptions_allowed=allowed),
    )


def _watch_deletes(store, sink):
    """Record every DELETED pod event (name, uid) — the double-eviction
    and budget-violation ledger."""
    w = store.watch("pods")

    def drain():
        for ev in w:
            if ev.type == "DELETED":
                sink.append(
                    (ev.object.metadata.name, ev.object.metadata.uid)
                )

    threading.Thread(target=drain, daemon=True).start()
    return w


def _bound(store, prefix, n):
    pods, _ = store.list("pods")
    mine = [p for p in pods if p.metadata.name.startswith(prefix)]
    return len(mine) == n and all(p.spec.node_name for p in mine)


def _fill(store, n_nodes, protected_per_node=2, free_per_node=2):
    """Full cluster: per node, `protected_per_node` PDB-covered prio-0
    pods (app=guarded) + `free_per_node` unprotected prio-0 pods
    (app=bulk). 4x1cpu pods fill each 4-cpu node."""
    for i in range(n_nodes):
        store.create("nodes", make_node(f"n{i}"))
    for i in range(n_nodes):
        for k in range(protected_per_node):
            store.create(
                "pods",
                make_pod(f"guard-{i}-{k}", prio=0, labels={"app": "guarded"}),
            )
        for k in range(free_per_node):
            store.create(
                "pods",
                make_pod(f"bulk-{i}-{k}", prio=0, labels={"app": "bulk"}),
            )


def test_warmup_compile_preempt_kernels():
    """The reference's compile absorber: the port compiles nothing, so
    here it is a first preemption burst on a full cluster (10 pods
    bound, 6 priority-100 pods that need victims all bound)."""
    store = ChaosStore()
    sched = Scheduler(store, KubeSchedulerConfiguration())
    _fill(store, 5)
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, "guard-", 10), 60)
        assert wait_until(lambda: _bound(store, "bulk-", 10), 60)
        # drive one burst through the unschedulable path: compiles the
        # grouped preempt_select shape the scenarios below reuse
        for i in range(6):
            store.create("pods", make_pod(f"warmhi-{i}", "2", prio=100))
        assert wait_until(lambda: _bound(store, "warmhi-", 6), 90)
    finally:
        sched.stop()


def test_preemption_storm_with_pdbs_zero_budget_violations():
    """The storm: 5 burst pods need 2 victims each over 8 nodes whose
    victim pool is half PDB-protected (budget 0). Unprotected victims
    always suffice (the oracle — like the reference — WILL evict
    violating victims as a last resort, so the zero-violation invariant
    needs them never to be the last resort; the slack nodes absorb the
    preempt-then-steal races a tight fit produces). All burst pods bind,
    no guarded pod is EVER deleted, no uid is deleted twice, acked binds
    stay intact."""
    store = ChaosStore()
    deletes = []
    _watch_deletes(store, deletes)
    store.create("poddisruptionbudgets", _pdb("guard", "guarded", 0))
    sched = Scheduler(store, KubeSchedulerConfiguration())
    _fill(store, 8)
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, "guard-", 16), 60)
        assert wait_until(lambda: _bound(store, "bulk-", 16), 60)
        for i in range(5):
            store.create("pods", make_pod(f"hi-{i}", "2", prio=100))
        assert wait_until(lambda: _bound(store, "hi-", 5), 120)
    finally:
        sched.stop()
    # zero budget violations: the guarded pods all survive
    assert not [n for n, _ in deletes if n.startswith("guard-")], deletes
    pods, _ = store.list("pods")
    assert sum(1 for p in pods if p.metadata.name.startswith("guard-")) == 16
    # zero double-evictions
    uids = [u for _, u in deletes]
    assert len(uids) == len(set(uids)), "a victim uid was deleted twice"
    assert_bind_invariants(store, allow_deleted=True)


def test_kill_leader_mid_preemption_victims_not_reevicted():
    """Scheduler A dies right after its first victim eviction lands; B
    takes over the same store. The burst completes under B, victim
    deletes stay at the MINIMAL count (2 per burst pod — B places the
    burst into capacity A's evictions already freed instead of evicting
    again), and no uid is ever deleted twice."""
    store = ChaosStore()
    deletes = []
    _watch_deletes(store, deletes)
    sched_a = Scheduler(store, KubeSchedulerConfiguration())
    _fill(store, 6, protected_per_node=0, free_per_node=4)
    first_delete = threading.Event()
    real_delete = store.delete

    def signalling_delete(kind, ns, name, **kw):
        out = real_delete(kind, ns, name, **kw)
        if kind == "pods":
            first_delete.set()
        return out

    store.delete = signalling_delete
    sched_a.start()
    try:
        assert wait_until(lambda: _bound(store, "bulk-", 24), 60)
        for i in range(4):
            store.create("pods", make_pod(f"hi-{i}", "2", prio=100))
        assert first_delete.wait(60), "no victim was ever evicted"
    finally:
        # the kill: A goes down with evictions already applied and the
        # burst pods still pending/nominated
        sched_a.stop()
    sched_b = Scheduler(store, KubeSchedulerConfiguration())
    sched_b.start()
    try:
        assert wait_until(lambda: _bound(store, "hi-", 4), 120)
    finally:
        sched_b.stop()
    uids = [u for _, u in deletes]
    assert len(uids) == len(set(uids)), "a victim uid was deleted twice"
    # minimal victim count: 4 burst pods x 2 victims each. A re-evicting
    # successor would exceed it (adoption must reuse A's freed capacity).
    assert len(uids) <= 8, f"{len(uids)} evictions for 4 burst pods"
    assert_bind_invariants(store, allow_deleted=True)


def test_degraded_store_preemption_is_counted_skip_then_recovers():
    """Victim deletes against a degraded (read-only) store must abort the
    attempt as a counted skip — the FIRST refused delete unwinds the
    whole attempt, nothing is half-evicted — and the storm completes
    once deletes land again."""
    from kubernetes_tpu_torch.runtime.consensus import DegradedWrites

    store = ChaosStore()
    deletes = []
    _watch_deletes(store, deletes)
    sched = Scheduler(store, KubeSchedulerConfiguration())
    _fill(store, 5, protected_per_node=0, free_per_node=4)
    # a bounded degraded window on pod deletes only (creates/binds stay
    # healthy so the scenario is deterministic): the first victim delete
    # 503s retryably, then the store heals
    fail = {"n": 0}
    real_delete = store.delete

    def degraded_delete(kind, ns, name, **kw):
        if kind == "pods" and fail["n"] < 1:
            fail["n"] += 1
            raise DegradedWrites("chaos: victim delete refused (degraded)")
        return real_delete(kind, ns, name, **kw)

    store.delete = degraded_delete
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, "bulk-", 20), 60)
        for i in range(5):
            store.create("pods", make_pod(f"hi-{i}", "2", prio=100))

        def skips():
            return sum(
                v
                for name, labels, v in metrics.snapshot_counters(
                    "scheduler_degraded_write_skips_total"
                )
                if labels.get("write") in ("preempt_delete", "preemption")
            )

        assert wait_until(lambda: skips() >= 1, 60)
        # the refused attempt evicted NOTHING (first refusal aborts the
        # whole attempt) and parked every burst pod unschedulable
        assert fail["n"] >= 1
        assert not deletes
        # recovery: cluster churn (any node event) flushes unschedulableQ
        # — production gets this for free; the quiet test cluster needs
        # one poke (the 60 s leftover flush would get there too, slower)
        node = store.get("nodes", "", "n0")
        node.metadata.labels["chaos/poke"] = "1"
        store.update("nodes", node)
        assert wait_until(lambda: _bound(store, "hi-", 5), 120)
    finally:
        sched.stop()
    uids = [u for _, u in deletes]
    assert len(uids) == len(set(uids))
    assert_bind_invariants(store, allow_deleted=True)
