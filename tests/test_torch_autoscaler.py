"""The port's cluster autoscaler (kubernetes_tpu_torch/autoscaler/) against
the reference, on the CPU (the port at device="cpu").

(a) Every scenario of tests/test_autoscaler.py (17 tests), run on both
    packages with the same API objects and the port given the
    reference's per-pass tie noise (``ReferenceNoise`` of
    tests/test_torch_whatif.py). Deterministic results must be equal:
    ``plan_scale_up``'s nodes per group, ``placed``, ``unplaced``,
    ``truncated``, ``capped`` and ``skipped``; ``simulate_drain``
    verdicts and reasons; the overlay's rows; the queue's pending sets;
    the autoscaler's gauges, counters and health lines (the simulation
    histogram's line is a wall time and is compared by name). Each test
    also holds the port to the reference test's own assertions.
(b) ``ClusterAutoscaler.run_once()`` on both packages over one pending
    set, two passes (the second after the first pass's nodes registered
    and more pods arrived), the reference's noise injected into the
    port's simulator: the provisioned node names per group are equal.
(c) The scenarios of tests/test_chaos_autoscaler.py (5 tests), threaded,
    on the port alone (hollow kubelets, the Scheduler, the autoscaler and
    a ChaosStore bind ledger on the port's APIServer), held to the
    reference test's own assertions: the first what-if pass on a running
    Scheduler's cache, scale-up binding within one period, scale-down
    only after a passing drain simulation, the infeasible drain never
    cordoned or evicted, and a degraded store pausing provisioning.

Tolerances: exact, apart from wall-clock budgets, which are the
reference test's own.
"""

import importlib
import threading
import time
from collections import defaultdict
from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.autoscaler import (
    ClusterAutoscaler,
    NodeGroup,
    NodeGroupCatalog,
    WhatIfSimulator,
    machine_shape,
)
from kubernetes_tpu_torch.client.apiserver import APIServer, NotFound
from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
from kubernetes_tpu_torch.kubemark.hollow_node import HollowCluster
from kubernetes_tpu_torch.perf.harness import default_config
from kubernetes_tpu_torch.runtime.consensus import DegradedWrites, QuorumLost
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_whatif import ReferenceNoise

REF, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"


def mods(pkg):
    imp = importlib.import_module
    return SimpleNamespace(
        pkg=pkg,
        v1=imp(f"{pkg}.api.objects"),
        auto=imp(f"{pkg}.autoscaler"),
        controller=imp(f"{pkg}.autoscaler.controller"),
        cache=imp(f"{pkg}.scheduler.cache.cache"),
        queue=imp(f"{pkg}.scheduler.queue"),
        metrics=imp(f"{pkg}.utils.metrics").metrics,
        server=imp(f"{pkg}.client.apiserver").APIServer,
        config=imp(f"{pkg}.scheduler.config").KubeSchedulerConfiguration,
        scheduler=imp(f"{pkg}.scheduler.scheduler").Scheduler,
    )


def both(scenario):
    """scenario(m) on the reference and on the port; asserts the results
    equal and returns the port's."""
    ref = scenario(mods(REF))
    port = scenario(mods(PORT))
    assert port == ref, f"port {port} != reference {ref}"
    return port


def new_cache(m):
    if m.pkg == PORT:
        from kubernetes_tpu_torch.ops.encoding import SnapshotEncoder

        return m.cache.SchedulerCache(encoder=SnapshotEncoder(device="cpu"))
    return m.cache.SchedulerCache()


def new_sim(m, cache, **kw):
    if m.pkg == PORT:
        kw["noise"] = ReferenceNoise()
    return m.auto.WhatIfSimulator(cache, **kw)


def new_scheduler(m, server):
    if m.pkg == PORT:
        return m.scheduler(server, default_config(), device="cpu")
    return m.scheduler(server, m.config())


def make_node(m, name, cpu="4", memory="32Gi", pods=110, labels=None):
    return m.auto.machine_shape(cpu=cpu, memory=memory, pods=pods, labels=labels)(name)


def make_pod(m, name, cpu="100m", node=None, node_selector=None, owners=None):
    o = m.v1
    p = o.Pod(
        metadata=o.ObjectMeta(name=name, owner_references=list(owners or [])),
        spec=o.PodSpec(
            containers=[o.Container(requests={"cpu": cpu})],
            node_selector=dict(node_selector or {}),
        ),
    )
    if node:
        p.spec.node_name = node
    return p


def fill_cache(m, n_nodes=3, pods_per_node=2, cpu="4"):
    cache = new_cache(m)
    for i in range(n_nodes):
        cache.add_node(make_node(m, f"node-{i}", cpu=cpu))
    for i in range(n_nodes):
        for j in range(pods_per_node):
            cache.add_pod(make_pod(m, f"pod-{i}-{j}", node=f"node-{i}"))
    return cache


def plan_tuple(plan):
    return (
        dict(plan.nodes), plan.placed, plan.unplaced, plan.truncated,
        plan.capped, plan.skipped,
    )


def verdict_tuple(v):
    return (v.ok, v.reason, v.replaced)


# -- (a) tests/test_autoscaler.py on both packages ---------------------------


def test_whatif_overlay_leaves_live_tensors_bit_identical():
    def scenario(m):
        cache = fill_cache(m)
        with cache.lock:
            cache.encoder.flush()
        live_before = cache.encoder._device
        before = [np_copy(t) for t in live_before]
        sim = new_sim(m, cache)
        res = sim.simulate(
            [make_pod(m, f"pend-{i}", cpu="2") for i in range(8)],
            [make_node(m, "virt-0", cpu="8"), make_node(m, "virt-1", cpu="8")],
            mask_node="node-1",
        )
        assert res is not None and (res.chosen >= 0).any()
        assert cache.encoder._device is live_before
        for name, b, now in zip(live_before._fields, before, live_before):
            assert (b == np_copy(now)).all(), name
        return (res.chosen.tolist(), res.fallback.tolist(), res.virtual_rows)

    both(scenario)


def np_copy(t):
    import numpy as np

    return t.cpu().numpy().copy() if hasattr(t, "cpu") else np.asarray(t).copy()


def test_whatif_overlay_appends_virtual_rows_and_masks():
    def scenario(m):
        cache = fill_cache(m, n_nodes=2)
        enc = cache.encoder
        with cache.lock:
            enc.flush()
            snap, rows = enc.whatif_overlay(
                [make_node(m, "virt-0", cpu="8")], mask_rows=[enc.row_of("node-0")]
            )
        valid = np_copy(snap.valid)
        assert valid[rows[0]] and not valid[enc.row_of("node-0")]
        assert np_copy(enc._device.valid)[enc.row_of("node-0")]
        assert rows[0] not in (enc.row_of("node-0"), enc.row_of("node-1"))
        return rows, valid.tolist()

    both(scenario)


def test_whatif_overlay_refuses_when_no_free_rows():
    def scenario(m):
        cache = new_cache(m)
        enc = cache.encoder
        with cache.lock:
            for i in range(enc.cfg.n_cap):
                cache.add_node(make_node(m, f"n-{i}"))
            enc.flush()
            return enc.whatif_overlay([make_node(m, "v-0")]), enc.cfg.n_cap

    assert both(scenario)[0] is None


def test_encode_node_row_values_matches_write_node_row():
    import numpy as np

    def scenario(m):
        cache = new_cache(m)
        node = make_node(
            m, "n-0", cpu="8", memory="16Gi", labels={"zone": "z1", "rank": "3"}
        )
        node.spec.taints = [m.v1.Taint("dedicated", "infra", m.v1.TAINT_NO_SCHEDULE)]
        cache.add_node(node)
        enc = cache.encoder
        row = enc.row_of("n-0")
        vals = enc.encode_node_row_values(node)
        assert bool(enc.m_valid[row]) is True
        np.testing.assert_array_equal(enc.m_alloc[row], vals["allocatable"])
        np.testing.assert_array_equal(enc.m_label_vals[row], vals["label_vals"])
        np.testing.assert_array_equal(enc.m_taint_key[row], vals["taint_key"])
        np.testing.assert_array_equal(enc.m_taint_eff[row], vals["taint_effect"])
        return {k: np.asarray(v).tolist() for k, v in vals.items()}

    both(scenario)


def test_plan_scale_up_packs_fewest_virtual_nodes():
    def scenario(m):
        cache = fill_cache(m, n_nodes=3, pods_per_node=2, cpu="4")
        for i in range(3):
            for j in range(2):
                cache.remove_pod(make_pod(m, f"pod-{i}-{j}", node=f"node-{i}"))
                cache.add_pod(make_pod(m, f"big-{i}-{j}", cpu="1900m", node=f"node-{i}"))
        sim = new_sim(m, cache)
        catalog = m.auto.NodeGroupCatalog(
            [m.auto.NodeGroup(name="std", template=m.auto.machine_shape(cpu="4"), max_size=20)]
        )
        pending = [make_pod(m, f"pend-{i}", cpu="1") for i in range(8)]
        return plan_tuple(m.auto.plan_scale_up(
            sim, catalog, pending, {"std": 0}, {"node-0", "node-1", "node-2"}
        ))

    nodes, placed, unplaced, *_ = both(scenario)
    assert placed == 8 and unplaced == 0
    assert sorted(nodes) == ["std"] and len(nodes["std"]) == 2


def test_plan_scale_up_no_nodes_when_pods_fit_existing():
    def scenario(m):
        cache = fill_cache(m, n_nodes=2, pods_per_node=0)
        catalog = m.auto.NodeGroupCatalog(
            [m.auto.NodeGroup(name="std", template=m.auto.machine_shape(cpu="4"), max_size=20)]
        )
        return plan_tuple(m.auto.plan_scale_up(
            new_sim(m, cache), catalog, [make_pod(m, "pend-0", cpu="1")],
            {"std": 0}, {"node-0", "node-1"},
        ))

    nodes, placed, *_ = both(scenario)
    assert nodes == {} and placed == 1


def test_plan_scale_up_respects_max_size():
    def scenario(m):
        cache = new_cache(m)
        cache.add_node(make_node(m, "node-0", cpu="1"))
        catalog = m.auto.NodeGroupCatalog(
            [m.auto.NodeGroup(name="std", template=m.auto.machine_shape(cpu="4"), max_size=1)]
        )
        pending = [make_pod(m, f"pend-{i}", cpu="3") for i in range(6)]
        return plan_tuple(m.auto.plan_scale_up(
            new_sim(m, cache), catalog, pending, {"std": 1}, {"node-0"}
        ))

    nodes, *_, skipped = both(scenario)
    assert nodes == {} and skipped


def test_plan_scale_up_picks_shape_that_fits():
    def scenario(m):
        cache = new_cache(m)
        cache.add_node(make_node(m, "node-0", cpu="1"))
        catalog = m.auto.NodeGroupCatalog([
            m.auto.NodeGroup(name="small", template=m.auto.machine_shape(cpu="2"), max_size=10),
            m.auto.NodeGroup(name="big", template=m.auto.machine_shape(cpu="16"), max_size=10),
        ])
        return plan_tuple(m.auto.plan_scale_up(
            new_sim(m, cache), catalog, [make_pod(m, "huge", cpu="8")],
            {"small": 0, "big": 0}, {"node-0"},
        ))

    nodes, placed, *_ = both(scenario)
    assert placed == 1 and list(nodes) == ["big"] and len(nodes["big"]) == 1


def test_cheapest_feasible_shape_beats_most_allocated_on_cost():
    def catalog(m):
        shape = m.auto.machine_shape
        return m.auto.NodeGroupCatalog([
            m.auto.NodeGroup(name="pricey", template=shape(
                cpu="8", cost_per_hour=9.5, accelerator_class="tpu-v5p",
                energy_watts=800.0), max_size=20),
            m.auto.NodeGroup(name="cheap", template=shape(
                cpu="8", cost_per_hour=0.8, accelerator_class="tpu-v5e",
                energy_watts=250.0), max_size=20),
        ])

    def scenario(m):
        pending = [make_pod(m, f"p{i}", cpu="2") for i in range(12)]
        out = {}
        for aware in (True, False):
            cache = new_cache(m)
            cache.add_node(make_node(m, "seed-0", cpu="1"))
            sim = new_sim(m, cache, cost_aware=aware)
            cat = catalog(m)
            plan = m.auto.plan_scale_up(
                sim, cat, pending, {"pricey": 0, "cheap": 0}, {"seed-0"}
            )
            cost = sum(
                cat.group(g).cost_per_hour() * len(n) for g, n in plan.nodes.items()
            )
            out[aware] = plan_tuple(plan) + (cost,)
        return out

    out = both(scenario)
    aware, blind = out[True], out[False]
    assert aware[1] == blind[1] == 12
    assert sum(map(len, aware[0].values())) == sum(map(len, blind[0].values()))
    assert list(aware[0]) == ["cheap"]
    assert aware[-1] < blind[-1]


def _reset_metrics():
    for pkg in (REF, PORT):
        mods(pkg).metrics.reset()


def test_fleet_cost_gauge_sums_labeled_nodes():
    _reset_metrics()

    def scenario(m):
        sched = new_scheduler(m, m.server())
        groups = [m.auto.NodeGroup(
            name="spot", template=m.auto.machine_shape(cpu="8", cost_per_hour=1.5),
            max_size=4,
        )]
        auto = m.auto.ClusterAutoscaler(
            sched.server, sched, m.auto.NodeGroupCatalog(groups),
            scale_down_enabled=False,
        )
        for i in range(3):
            sched.cache.add_node(groups[0].make_node(f"spot-{i}"))
        sched.cache.add_node(make_node(m, "unlabeled"))
        auto.run_once()
        return m.metrics.gauge(m.controller.GAUGE_SHAPE_COST_FLEET)

    assert both(scenario) == pytest.approx(4.5)


def test_simulate_drain_ok_when_pods_replace():
    def scenario(m):
        cache = fill_cache(m, n_nodes=3, pods_per_node=1, cpu="4")
        resident = list(cache.get_node_info("node-0").pods)
        return verdict_tuple(m.auto.simulate_drain(new_sim(m, cache), "node-0", resident))

    ok, _reason, replaced = both(scenario)
    assert ok and replaced == 1


def test_simulate_drain_blocked_when_pod_cannot_replace():
    def scenario(m):
        cache = new_cache(m)
        cache.add_node(make_node(m, "pinned", cpu="4", labels={"pin": "yes"}))
        cache.add_node(make_node(m, "other", cpu="4"))
        pod = make_pod(m, "stuck", cpu="100m", node="pinned", node_selector={"pin": "yes"})
        cache.add_pod(pod)
        return verdict_tuple(m.auto.simulate_drain(new_sim(m, cache), "pinned", [pod]))

    ok, reason, _ = both(scenario)
    assert not ok and "do not re-place" in reason


def test_simulate_drain_empty_node_is_ok():
    def scenario(m):
        cache = fill_cache(m, n_nodes=2, pods_per_node=0)
        return verdict_tuple(m.auto.simulate_drain(new_sim(m, cache), "node-0", []))

    assert both(scenario)[0]


def test_move_all_flushes_expired_backoff_straight_to_active():
    def scenario(m):
        q = m.queue.PriorityQueue()
        pi = m.queue.QueuedPodInfo(make_pod(m, "p-0"))
        pi.attempts = 1
        q.add_unschedulable_if_not_present(pi, q.moves)
        assert q.pending_pods()["unschedulable"] == [pi.key]
        pi.timestamp = time.monotonic() - 30.0
        q.move_all_to_active_or_backoff("NodeAdd")
        return q.pending_pods(), pi.key

    pending, key = both(scenario)
    assert pending["active"] == [key] and pending["backoff"] == []


def test_move_all_still_backs_off_fresh_failures():
    def scenario(m):
        q = m.queue.PriorityQueue(pod_initial_backoff=5.0)
        pi = m.queue.QueuedPodInfo(make_pod(m, "p-0"))
        pi.attempts = 1
        q.add_unschedulable_if_not_present(pi, q.moves)
        q.move_all_to_active_or_backoff("NodeAdd")
        return q.pending_pods(), pi.key

    pending, key = both(scenario)
    assert pending["backoff"] == [key] and pending["active"] == []


def test_unschedulable_pod_infos_snapshot_is_nonconsuming():
    def scenario(m):
        q = m.queue.PriorityQueue()
        pi = m.queue.QueuedPodInfo(make_pod(m, "p-0"))
        q.add_unschedulable_if_not_present(pi, q.moves)
        names = [p.pod.metadata.name for p in q.unschedulable_pod_infos()]
        return names, q.pending_pods()["unschedulable"]

    names, unsched = both(scenario)
    assert names == ["p-0"] and unsched == ["default/p-0"]


def test_autoscaler_metrics_and_health_lines():
    _reset_metrics()

    def scenario(m):
        cache = fill_cache(m, n_nodes=2, pods_per_node=0)
        sim = new_sim(m, cache)
        sim.simulate([make_pod(m, "p-0")], [make_node(m, "v-0")])
        passes = m.metrics.counter(
            "autoscaler_simulation_passes_total", {"kind": "scale_up"}
        )
        m.metrics.set_gauge("autoscaler_pending_pods", 3.0)
        lines = m.controller.autoscaler_health_lines()
        hist = [ln for ln in lines if "autoscaler_simulation_duration_seconds" in ln]
        assert len(hist) == 1 and "n=1 " in hist[0]
        assert "autoscaler_pending_pods" in m.metrics.render_prometheus()
        return passes, [ln for ln in lines if ln not in hist]

    passes, lines = both(scenario)
    assert passes == 1.0
    assert any("autoscaler_pending_pods" in ln for ln in lines)


# -- (b) ClusterAutoscaler.run_once on both packages -------------------------


@pytest.mark.parametrize(
    "catalog", ["autoscaler_candidate_shapes", "hetero_candidate_shapes"]
)
def test_run_once_provisions_the_reference_nodes(catalog):
    """Two passes over one pending set, no scheduler thread running: the
    pending pods sit in the unschedulable queue, 4 small nodes are full,
    the catalog has four shapes. After the first pass its nodes register
    (added to the cache as the informer would) and more pods arrive; the
    second pass plans against them. Node names per group, the plan
    counters and the pending gauge equal the reference's after each
    pass."""
    _reset_metrics()

    def scenario(m):
        from_catalog = getattr(
            importlib.import_module(f"{m.pkg}.perf.workloads"),
            catalog,
        )
        server = m.server()
        sched = new_scheduler(m, server)
        groups = from_catalog()
        auto = m.auto.ClusterAutoscaler(
            server, sched, m.auto.NodeGroupCatalog(groups),
            scale_down_enabled=False, max_provision_per_cycle=6,
        )
        if m.pkg == PORT:
            auto.sim.noise = ReferenceNoise()
        for i in range(4):
            node = make_node(m, f"full-{i}", cpu="2")
            server.create("nodes", node)
            sched.cache.add_node(node)
            pod = make_pod(m, f"resident-{i}", cpu="1900m", node=f"full-{i}")
            server.create("pods", pod)
            sched.cache.add_pod(pod)
        q = sched.queue
        out = []
        for rnd, (n_pods, cpu) in enumerate(((40, "500m"), (30, "3"))):
            for i in range(n_pods):
                pi = m.queue.QueuedPodInfo(make_pod(m, f"pend-{rnd}-{i}", cpu=cpu))
                pi.attempts = 1
                q.add_unschedulable_if_not_present(pi, q.moves)
            before = {n.metadata.name for n in server.list("nodes")[0]}
            auto.run_once()
            nodes = [n for n in server.list("nodes")[0] if n.metadata.name not in before]
            by_group = defaultdict(list)
            for n in nodes:
                by_group[n.metadata.labels[m.v1.LABEL_NODEGROUP]].append(n.metadata.name)
                sched.cache.add_node(n)  # the informer's node-add
            out.append((
                {g: sorted(v) for g, v in by_group.items()},
                m.metrics.gauge("autoscaler_pending_pods"),
                m.metrics.counter("autoscaler_unplaced_pods_total"),
                sorted(
                    (l["group"], v) for _n, l, v in m.metrics.snapshot_counters(
                        "autoscaler_nodes_provisioned_total"
                    )
                ),
            ))
        return out

    (first, *_), (second, *_) = both(scenario)
    assert first and second
    assert sum(map(len, first.values())) <= 6


# -- (c) tests/test_chaos_autoscaler.py on the port --------------------------


def wait_until(fn, timeout=60.0, period=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


class _GateConsensus:
    """Flips the store between healthy and degraded read-only (the
    contract runtime/consensus.py arms: writes 503 retryably, reads
    serve)."""

    def __init__(self):
        self.degraded = False

    def check_writable(self):
        if self.degraded:
            raise DegradedWrites("chaos: store degraded (read-only)")


class ChaosStore(APIServer):
    """The port's APIServer with tests/test_chaos_pipeline.py's chaos knobs
    and bind-invariant ledger: ``acked_binds`` (pod uid -> node for every
    acknowledged bind), ``applied_binds`` (applications per uid),
    ``degrade()`` / ``recover()``."""

    def __init__(self):
        super().__init__()
        self.gate = _GateConsensus()
        self.write_gate.attach_consensus(self.gate)
        self.acked_binds = {}
        self.applied_binds = defaultdict(int)
        self.fail_next_bind = None
        self._chaos_lock = threading.Lock()

    def degrade(self):
        self.gate.degraded = True

    def recover(self):
        self.gate.degraded = False

    def bind_pods(self, bindings, fence=None):
        with self._chaos_lock:
            mode, self.fail_next_bind = self.fail_next_bind, None
        if mode == "degraded":
            self.gate.degraded = True
            raise DegradedWrites("chaos: bind refused, store degraded")
        errors = super().bind_pods(bindings, fence=fence)
        for b, err in zip(bindings, errors):
            if err is None:
                self.applied_binds[b.pod_uid] += 1
        if mode == "quorum_lost":
            self.gate.degraded = True
            raise QuorumLost("chaos: bind applied locally, quorum ack lost")
        for b, err in zip(bindings, errors):
            if err is None:
                self.acked_binds[b.pod_uid] = b.target_node
        return errors


def assert_bind_invariants(store, allow_deleted=False):
    """Zero acked-bind loss + zero double-binds against the live store."""
    pods, _ = store.list("pods")
    by_uid = {p.metadata.uid: p for p in pods}
    lost = []
    for uid, node in store.acked_binds.items():
        cur = by_uid.get(uid)
        if cur is None:
            if not allow_deleted:
                lost.append((uid, node, "pod gone"))
            continue
        if cur.spec.node_name != node:
            lost.append((uid, node, f"bound to {cur.spec.node_name!r}"))
    assert not lost, f"acked binds lost: {lost}"
    doubles = {u: n for u, n in store.applied_binds.items() if n > 1}
    assert not doubles, f"double-applied binds: {doubles}"


def watch_deletions(store, sink):
    w = store.watch("pods")

    def drain():
        for ev in w:
            if ev.type == "DELETED":
                sink.append(ev.object.metadata.key)

    threading.Thread(target=drain, daemon=True).start()
    return w


def chaos_pod(name, cpu="1", node_selector=None, owners=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, owner_references=list(owners or [])),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": cpu})],
            node_selector=dict(node_selector or {}),
        ),
    )


def bound_count(store):
    return store.count("pods", lambda p: bool(p.spec.node_name))


def get_or_none(store, kind, ns, name):
    try:
        return store.get(kind, ns, name)
    except NotFound:
        return None


def _rig(store, groups, **auto_kw):
    """hollow kubelet pool + scheduler + autoscaler, wired together."""
    hollow = HollowCluster(store, heartbeat_interval=0.5, housekeeping_interval=0.1)
    for g in groups:
        g.provision, g.deprovision = hollow.provisioner_for(g.make_node)
    sched = Scheduler(store, default_config(), device="cpu")
    auto = ClusterAutoscaler(store, sched, NodeGroupCatalog(groups), **auto_kw)
    return hollow, sched, auto


def test_first_whatif_pass_on_a_running_scheduler():
    """The reference's compile absorber, as a scenario: one what-if pass
    against a running Scheduler's cache (mask + virtual row), then pods
    that fit nowhere reach the unschedulable queue through the failure
    handler's preemption what-if."""
    store = ChaosStore()
    sched = Scheduler(store, default_config(), device="cpu")
    sched.start()
    try:
        store.create("nodes", machine_shape(cpu="4", memory="32Gi", pods=32)("warm-n0"))
        assert wait_until(lambda: sched.cache.get_node_info("warm-n0") is not None, 10)
        sim = WhatIfSimulator(sched.cache)
        res = sim.simulate(
            [chaos_pod("warm-p0")],
            [machine_shape(cpu="4", memory="32Gi", pods=32)("warm-v0")],
            mask_node="warm-n0",
        )
        assert res is not None
        assert res.chosen.tolist() == [list(res.virtual_rows)[0]]
        for i in range(5):
            store.create("pods", chaos_pod(f"warm-big-{i}", cpu="64"))
        assert wait_until(lambda: len(sched.queue.unschedulable_pod_infos()) == 5, 30)
    finally:
        sched.stop()


def test_scale_up_pending_pods_bind_within_one_period():
    store = ChaosStore()
    period = 0.3
    group = NodeGroup(
        name="std", template=machine_shape(cpu="4", memory="32Gi", pods=32), max_size=16,
    )
    hollow, sched, auto = _rig(store, [group], period_s=period, scale_down_enabled=False)
    n = 12  # 1-cpu pods on 4-cpu shapes: 3 nodes
    for i in range(n):
        store.create("pods", chaos_pod(f"pend-{i}"))
    deletions = []
    w = watch_deletions(store, deletions)
    hollow.start()
    sched.start()
    try:
        assert wait_until(
            lambda: len(sched.queue.unschedulable_pod_infos()) == n, 30
        ), "pods never reached unschedulableQ"
        assert bound_count(store) == 0
        auto.start()
        assert wait_until(lambda: store.count("nodes") > 0, 15), "autoscaler never provisioned"
        t_nodes = time.monotonic()
        assert wait_until(lambda: bound_count(store) == n, 20), (
            f"only {bound_count(store)}/{n} bound after scale-up"
        )
        elapsed = time.monotonic() - t_nodes
        assert elapsed <= period + 4.5, f"bind-after-capacity budget blown: {elapsed:.1f}s"
        nodes, _ = store.list("nodes")
        assert 3 <= len(nodes) <= 4, f"expected ~3 nodes, got {len(nodes)}"
        assert not deletions, f"scale-up must evict nothing: {deletions}"
        assert_bind_invariants(store)
    finally:
        auto.stop()
        sched.stop()
        hollow.stop()
        w.stop()


def test_scale_down_drains_only_after_simulation_proves_replacement():
    store = ChaosStore()
    group = NodeGroup(
        name="pool", template=machine_shape(cpu="4", memory="32Gi", pods=32),
        min_size=2, max_size=8,
    )
    hollow, sched, auto = _rig(
        store, [group], period_s=0.2, scale_down_util_threshold=0.3,
        scale_down_unneeded_passes=2,
    )
    for i in range(3):
        hollow.add_node(f"pool-n{i}", template=group.make_node)
    rsc = ReplicaSetController(store, resync_period=0.5)
    rs = v1.ReplicaSet(
        metadata=v1.ObjectMeta(name="web"),
        spec=v1.ReplicaSetSpec(
            replicas=4,
            selector={"app": "web"},
            template=v1.PodTemplateSpec(
                metadata=v1.ObjectMeta(labels={"app": "web"}),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "1"})]),
            ),
        ),
    )
    store.create("replicasets", rs)
    hollow.start()
    sched.start()
    rsc.start()
    try:
        assert wait_until(lambda: bound_count(store) == 4, 30), (
            f"RS pods never all bound: {bound_count(store)}/4"
        )
        evictions0 = metrics.counter("autoscaler_evictions_total")
        auto.start()
        assert wait_until(lambda: store.count("nodes") == 2, 30), (
            f"fleet never converged to min_size: {store.count('nodes')} nodes"
        )
        assert wait_until(
            lambda: bound_count(store) == 4
            and all(
                p.spec.node_name != ""
                and get_or_none(store, "nodes", "", p.spec.node_name) is not None
                for p in store.list("pods")[0]
            ),
            30,
        ), "replicas did not re-place on surviving nodes"
        assert metrics.counter("autoscaler_evictions_total") > evictions0
        assert metrics.counter("autoscaler_nodes_removed_total", {"group": "pool"}) >= 1.0
        time.sleep(1.0)
        assert store.count("nodes") == 2
        assert_bind_invariants(store, allow_deleted=True)
        live_nodes = {n.metadata.name for n in store.list("nodes")[0]}
        assert set(hollow.nodes) == live_nodes
    finally:
        auto.stop()
        rsc.stop()
        sched.stop()
        hollow.stop()


def test_simulation_infeasible_node_is_never_drained():
    store = ChaosStore()
    pinned_shape = machine_shape(cpu="4", memory="32Gi", pods=32, labels={"pin": "yes"})
    group = NodeGroup(
        name="pool", template=machine_shape(cpu="4", memory="32Gi", pods=32),
        min_size=0, max_size=8,
    )
    hollow, sched, auto = _rig(
        store, [group], period_s=0.1, scale_down_util_threshold=0.5,
        scale_down_unneeded_passes=2,
    )

    def pinned_template(name):
        node = pinned_shape(name)
        node.metadata.labels[v1.LABEL_NODEGROUP] = group.name
        return node

    hollow.add_node("pool-pinned", template=pinned_template)
    hollow.add_node("pool-other", template=group.make_node)
    store.create(
        "pods",
        chaos_pod(
            "stuck", cpu="100m", node_selector={"pin": "yes"},
            owners=[v1.OwnerReference(kind="ReplicaSet", name="ghost")],
        ),
    )
    deletions = []
    w = watch_deletions(store, deletions)
    blocked = {"reason": "simulation_infeasible"}
    blocked0 = metrics.counter("autoscaler_scale_down_blocked_total", blocked)
    hollow.start()
    sched.start()
    try:
        assert wait_until(lambda: bound_count(store) == 1, 30)
        auto.start()
        assert wait_until(
            lambda: metrics.counter("autoscaler_scale_down_blocked_total", blocked) > blocked0,
            15,
        ), "drain simulation never evaluated the pinned node"
        time.sleep(1.0)
        node = get_or_none(store, "nodes", "", "pool-pinned")
        assert node is not None, "infeasible node was deleted"
        assert not node.spec.unschedulable, "infeasible node was cordoned"
        assert not deletions, f"zero-eviction guarantee broken: {deletions}"
        assert_bind_invariants(store)
    finally:
        auto.stop()
        sched.stop()
        hollow.stop()
        w.stop()


def test_degraded_store_pauses_provisioning_until_recovery():
    store = ChaosStore()
    group = NodeGroup(
        name="std", template=machine_shape(cpu="4", memory="32Gi", pods=32), max_size=8,
    )
    hollow, sched, auto = _rig(store, [group], period_s=0.2, scale_down_enabled=False)
    for i in range(4):
        store.create("pods", chaos_pod(f"pend-{i}"))
    hollow.start()
    sched.start()
    try:
        assert wait_until(lambda: len(sched.queue.unschedulable_pod_infos()) == 4, 30)
        store.degrade()
        skip = {"write": "provision"}
        skips0 = metrics.counter("autoscaler_degraded_write_skips_total", skip)
        auto.start()
        assert wait_until(
            lambda: metrics.counter("autoscaler_degraded_write_skips_total", skip) > skips0,
            15,
        ), "degraded store never produced a counted provision skip"
        assert store.count("nodes") == 0, "provisioned against a read-only store"
        store.recover()
        assert wait_until(lambda: bound_count(store) == 4, 20), (
            "scale-up never completed after store recovery"
        )
        assert_bind_invariants(store)
    finally:
        auto.stop()
        sched.stop()
        hollow.stop()
