"""The port's descheduler (kubernetes_tpu_torch/descheduler/, copies over
the ported what-if pass) on the CPU (the port at device="cpu").

(a) ``plan_consolidation`` on both packages over the same fragmented
    clusters (scheduler caches fed the same nodes and bound pods), the
    port given the reference's tie noise: the plans (evict-set, victims,
    node costs, re-placed count, encoder generation) or the rejection
    reasons are equal, and so are the rejection counters. Covered: the
    two light nodes of a fragmented fleet, an expensive light node
    sorted first, a multi-node set that only its first node can leave, a
    gang that would strand below quorum, unmovable pods, a cordoned
    candidate, a system-band victim, and no candidate at all.
(b) The scenarios of tests/test_chaos_defrag.py on the port alone, with
    the port's APIServer as a ChaosStore bind ledger (tests/
    test_torch_autoscaler.py), held to the reference test's own
    assertions: the first masked pass and planning pass on a running
    Scheduler, consolidation to fewer nodes and a lower bill, the drift
    abort, the gang strand at planning, the mid-plan gang change, the
    degraded store before and during a wave, the fenced descheduler and
    the orphan sweep, the eviction budget shared by three actors, the
    stale PDB column and the store's eviction gate against a host PDB
    oracle. The reference's RESTClient Retry-After test drives
    ``apiserver/client.py`` and ``apiserver/rest.py``, which the port has
    not copied yet (ROADMAP queue 1 item 5).

Tolerances: exact, apart from the eviction budget's token envelope,
which is the reference test's own.
"""

import importlib
import random
import threading
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.api.selectors import match_labels
from kubernetes_tpu_torch.autoscaler import (
    NodeGroup,
    NodeGroupCatalog,
    WhatIfSimulator,
    machine_shape,
)
from kubernetes_tpu_torch.client.apiserver import TooManyRequests
from kubernetes_tpu_torch.client.leaderelection import BindFence, Lease
from kubernetes_tpu_torch.controller.evictionbudget import EvictionBudget
from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
from kubernetes_tpu_torch.descheduler import Descheduler, PlanExecutor, plan_consolidation
from kubernetes_tpu_torch.descheduler.controller import descheduler_health_lines
from kubernetes_tpu_torch.descheduler.executor import ANN_DEFRAG
from kubernetes_tpu_torch.ops.encoding import LABEL_COST_PER_HOUR
from kubernetes_tpu_torch.perf.harness import default_config
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
    GROUP_LABEL,
    MIN_MEMBER_ANNOTATION,
)
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_autoscaler import (
    PORT,
    REF,
    ChaosStore,
    assert_bind_invariants,
    get_or_none,
    mods,
    new_cache,
    new_sim,
    wait_until,
    watch_deletions,
)

SHAPE = dict(cpu="8", memory="64Gi", pods=64)


# -- (a) plan_consolidation on both packages ---------------------------------


def _fleet(m, layout, gang=None, annotations=None, owners=True, priority=None):
    """A scheduler cache holding `layout` [(node, n_pods, cost)], every pod
    1 cpu; gang: {node: n} members of gang "ring" (quorum from
    annotations) among that node's pods."""
    o = m.v1
    cache = new_cache(m)
    g = importlib.import_module(f"{m.pkg}.autoscaler")
    n = 0
    for name, count, cost in layout:
        grp = g.NodeGroup(
            name="defrag", template=g.machine_shape(cost_per_hour=cost, **SHAPE),
            max_size=64,
        )
        cache.add_node(grp.make_node(name))
        for k in range(count):
            labels, ann = {}, {}
            if gang and k < gang.get(name, 0):
                labels = {GROUP_LABEL: "ring"}
                ann = dict(annotations or {})
            pod = o.Pod(
                metadata=o.ObjectMeta(
                    name=f"p{n}", labels=labels, annotations=ann,
                    owner_references=(
                        [o.OwnerReference(kind="ReplicaSet", name="rs")]
                        if owners else []
                    ),
                ),
                spec=o.PodSpec(
                    containers=[o.Container(requests={"cpu": "1"})],
                    node_name=name,
                    priority=priority,
                ),
            )
            cache.add_pod(pod)
            n += 1
    return cache


def _cordon(cache, name):
    node = cache.get_node_info(name).node.deep_copy()
    node.spec.unschedulable = True
    cache.update_node(node)


PLAN_CASES = {
    "two_light_nodes": dict(
        layout=[("h0", 6, 2.0), ("h1", 6, 2.0), ("l0", 2, 2.0), ("l1", 2, 2.0)],
        util=0.3, max_nodes=2,
    ),
    "expensive_light_first": dict(
        layout=[("h0", 5, 2.0), ("l0", 2, 2.0), ("l1", 2, 9.5), ("h1", 5, 2.0)],
        util=0.3, max_nodes=1,
    ),
    "set_infeasible_first_alone_fits": dict(
        layout=[("h0", 7, 2.0), ("h1", 7, 2.0), ("l0", 2, 2.0), ("l1", 3, 2.0)],
        util=0.4, max_nodes=2,
    ),
    "infeasible": dict(
        layout=[("h0", 8, 2.0), ("h1", 8, 2.0), ("l0", 2, 2.0)],
        util=0.3, max_nodes=2,
    ),
    "gang_strand": dict(
        layout=[("h0", 6, 2.0), ("l0", 2, 2.0)],
        util=0.3, max_nodes=2, gang={"h0": 2, "l0": 2},
        annotations={MIN_MEMBER_ANNOTATION: "4"},
    ),
    "gang_with_spare_quorum": dict(
        layout=[("h0", 6, 2.0), ("l0", 2, 2.0)],
        util=0.3, max_nodes=2, gang={"h0": 2, "l0": 2},
        annotations={MIN_MEMBER_ANNOTATION: "2"},
    ),
    "unmovable_pods": dict(
        layout=[("h0", 6, 2.0), ("l0", 2, 2.0)], util=0.3, max_nodes=1,
        owners=False,
    ),
    "cordoned_candidate": dict(
        layout=[("h0", 5, 2.0), ("l0", 2, 2.0), ("l1", 1, 2.0)],
        util=0.3, max_nodes=2, cordon="l1",
    ),
    "system_band": dict(
        layout=[("h0", 6, 2.0), ("l0", 2, 2.0)], util=0.3, max_nodes=1,
        priority=2_000_000_000,
    ),
    "no_candidates": dict(
        layout=[("h0", 6, 2.0), ("h1", 6, 2.0)], util=0.3, max_nodes=2,
    ),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_consolidation_matches_reference(case):
    kw = PLAN_CASES[case]

    def scenario(m):
        m.metrics.reset()
        cache = _fleet(
            m, kw["layout"], kw.get("gang"), kw.get("annotations"),
            kw.get("owners", True), kw.get("priority"),
        )
        if "cordon" in kw:
            _cordon(cache, kw["cordon"])
        planner = importlib.import_module(f"{m.pkg}.descheduler.planner")
        plan, reason = planner.plan_consolidation(
            new_sim(m, cache, max_pods_per_pass=64), cache,
            util_threshold=kw["util"], max_nodes_per_plan=kw["max_nodes"],
        )
        rejected = sorted(
            (l["reason"], v) for _n, l, v in m.metrics.snapshot_counters(
                "descheduler_plan_rejected_total"
            )
        )
        return (None if plan is None else plan.__dict__), reason, rejected

    ref = scenario(mods(REF))
    port = scenario(mods(PORT))
    assert port == ref
    expect = {
        "two_light_nodes": ["l0", "l1"],
        "expensive_light_first": ["l1"],
        "set_infeasible_first_alone_fits": ["l0"],
        "gang_with_spare_quorum": ["l0"],
        "cordoned_candidate": ["l0"],
    }
    if case in expect:
        assert port[0]["nodes"] == expect[case], port
    else:
        assert port[0] is None and port[1] in (
            "infeasible", "gang_strand", "no_candidates"
        ), port


# -- (b) tests/test_chaos_defrag.py on the port -------------------------------


def _shape(cost=2.0):
    return machine_shape(cost_per_hour=cost, **SHAPE)


def make_node(name, cost=2.0):
    return NodeGroup(name="defrag", template=_shape(cost), max_size=64).make_node(name)


def make_bound_pod(name, node, cpu="1", labels=None, annotations=None, owners=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(
            name=name,
            labels=dict(labels or {}),
            annotations=dict(annotations or {}),
            owner_references=list(
                owners if owners is not None
                else [v1.OwnerReference(kind="ReplicaSet", name="rs-ghost")]
            ),
        ),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})], node_name=node),
    )


def _bound_count(store):
    return store.count("pods", lambda p: bool(p.spec.node_name))


def _fragmented_fleet(store, heavy=2, light=2, heavy_pods=6, light_pods=2):
    n = 0
    for i in range(heavy):
        store.create("nodes", make_node(f"defrag-h{i}"))
        for _ in range(heavy_pods):
            store.create("pods", make_bound_pod(f"p{n}", f"defrag-h{i}"))
            n += 1
    for i in range(light):
        store.create("nodes", make_node(f"defrag-l{i}"))
        for _ in range(light_pods):
            store.create("pods", make_bound_pod(f"p{n}", f"defrag-l{i}"))
            n += 1
    return n


def _started_scheduler(store):
    sched = Scheduler(store, default_config(), device="cpu")
    sched.start()
    return sched


def _cache_pods(sched):
    return sum(len(ni.pods) for ni in sched.cache.node_infos().values())


def _wait_cache(sched, n_pods, timeout=30):
    assert wait_until(lambda: _cache_pods(sched) == n_pods, timeout), (
        "scheduler cache never caught up with the pre-placed fleet"
    )


def _fleet_cost(store) -> float:
    total = 0.0
    for node in store.list("nodes")[0]:
        raw = node.metadata.labels.get(LABEL_COST_PER_HOUR)
        total += float(raw) if raw else 0.0
    return round(total, 3)


def test_first_masked_pass_and_plan_on_a_running_scheduler():
    """The reference's compile absorber, as a scenario: a multi-node mask
    pass, a planning pass and one bind through the scheduler."""
    store = ChaosStore()
    sched = _started_scheduler(store)
    try:
        for i in range(2):
            store.create("nodes", make_node(f"warm-n{i}"))
        store.create("pods", make_bound_pod("warm-p0", "warm-n0"))
        _wait_cache(sched, 1)
        sim = WhatIfSimulator(sched.cache)
        res = sim.simulate(
            [make_bound_pod("warm-c0", "")], [], mask_nodes=["warm-n0"], kind="defrag"
        )
        assert res is not None
        assert res.chosen.tolist() == [sched.cache.encoder.row_of("warm-n1")]
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.9, max_nodes_per_plan=1
        )
        assert plan is not None or reason
        store.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name="warm-sched"),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "1"})]),
            ),
        )
        assert wait_until(
            lambda: (get_or_none(store, "pods", "default", "warm-sched")
                     or v1.Pod()).spec.node_name != "",
            30,
        )
    finally:
        sched.stop()


def test_consolidation_reduces_node_count_and_fleet_cost():
    store = ChaosStore()
    heavy, light, heavy_pods, light_pods = 3, 3, 6, 2
    n_pods = heavy * heavy_pods + light * light_pods
    rs = v1.ReplicaSet(
        metadata=v1.ObjectMeta(name="web"),
        spec=v1.ReplicaSetSpec(
            replicas=n_pods,
            selector={"app": "web"},
            template=v1.PodTemplateSpec(
                metadata=v1.ObjectMeta(labels={"app": "web"}),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "1"})]),
            ),
        ),
    )
    store.create("replicasets", rs)
    owners = [v1.OwnerReference(kind="ReplicaSet", name="web", uid=rs.metadata.uid,
                                controller=True)]
    n = 0
    for prefix, count, per in (("h", heavy, heavy_pods), ("l", light, light_pods)):
        for i in range(count):
            store.create("nodes", make_node(f"defrag-{prefix}{i}"))
            for _ in range(per):
                store.create("pods", make_bound_pod(
                    f"p{n}", f"defrag-{prefix}{i}", labels={"app": "web"}, owners=owners,
                ))
                n += 1
    sched = _started_scheduler(store)
    rsc = ReplicaSetController(store, resync_period=0.3)
    desch = Descheduler(
        store, sched, EvictionBudget(qps=100.0, burst=20), period_s=0.1,
        util_threshold=heavy_pods / 8, max_nodes_per_plan=2,
    )
    rsc.start()
    try:
        _wait_cache(sched, n_pods)
        nodes0 = store.count("nodes")
        cost0 = _fleet_cost(store)
        desch.start()
        assert wait_until(lambda: store.count("nodes") == heavy, 120), (
            f"fleet never consolidated: {store.count('nodes')} nodes (from {nodes0})"
        )
        assert wait_until(
            lambda: _bound_count(store) == n_pods
            and all(
                get_or_none(store, "nodes", "", p.spec.node_name) is not None
                for p in store.list("pods")[0]
            ),
            60,
        ), "replicas did not all re-place on the surviving fleet"
        cost1 = _fleet_cost(store)
        assert store.count("nodes") < nodes0
        assert cost1 < cost0, f"fleet bill did not drop: {cost0} -> {cost1}"
        assert metrics.counter("descheduler_plans_completed_total") >= 1
        assert metrics.counter("descheduler_evictions_total") >= light * light_pods
        assert metrics.counter("descheduler_cost_saved_milli_total") >= light * 2000
        assert_bind_invariants(store, allow_deleted=True)
        assert any("descheduler_plans_total" in ln for ln in descheduler_health_lines())
    finally:
        desch.stop()
        rsc.stop()
        sched.stop()


def test_drift_abort_rolls_back_cordons_with_zero_evictions():
    store = ChaosStore()
    n_pods = _fragmented_fleet(store, heavy=2, light=2, heavy_pods=6, light_pods=2)
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, n_pods)
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.3, max_nodes_per_plan=2
        )
        assert plan is not None, f"planner found no plan: {reason}"
        assert set(plan.nodes) == {"defrag-l0", "defrag-l1"}
        ex = PlanExecutor(store, sched, sim, EvictionBudget(100.0, 50))
        ex.adopt(plan)
        burst = 0
        for i in range(2):
            for j in range(2):
                store.create("pods", make_bound_pod(f"burst-{i}-{j}", f"defrag-h{i}"))
                burst += 1
        _wait_cache(sched, n_pods + burst)
        deletions = []
        w = watch_deletions(store, deletions)
        drift = {"reason": "drift"}
        aborts0 = metrics.counter("descheduler_plan_aborts_total", drift)
        evictions0 = metrics.counter("descheduler_evictions_total")
        try:
            assert ex.tick() is False, "drifted plan must abort, not latch"
            assert metrics.counter("descheduler_plan_aborts_total", drift) == aborts0 + 1
            assert metrics.counter("descheduler_evictions_total") == evictions0
            time.sleep(0.3)
            assert not deletions, f"evictions happened after drift: {deletions}"
            assert metrics.counter("descheduler_rollback_uncordons_total") >= 2
            for name in plan.nodes:
                node = store.get("nodes", "", name)
                assert not node.spec.unschedulable, f"{name} still cordoned"
                assert ANN_DEFRAG not in node.metadata.annotations
            assert not ex.active
            assert_bind_invariants(store)
        finally:
            w.stop()
    finally:
        sched.stop()


def _gang_fleet(store, quorum):
    store.create("nodes", make_node("defrag-h0"))
    store.create("nodes", make_node("defrag-l0"))
    gang = {GROUP_LABEL: "ring"}
    ann = {MIN_MEMBER_ANNOTATION: str(quorum)}
    for i in range(2):
        store.create("pods", make_bound_pod(f"g-l{i}", "defrag-l0", labels=gang, annotations=ann))
        store.create("pods", make_bound_pod(f"g-h{i}", "defrag-h0", labels=gang, annotations=ann))
    for i in range(4):
        store.create("pods", make_bound_pod(f"fill-{i}", "defrag-h0"))


def test_gang_strand_rejected_at_simulation_time():
    store = ChaosStore()
    _gang_fleet(store, quorum=4)
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, 8)
        sim = WhatIfSimulator(sched.cache)
        strand = {"reason": "gang_strand"}
        strands0 = metrics.counter("descheduler_plan_rejected_total", strand)
        deletions = []
        w = watch_deletions(store, deletions)
        try:
            plan, reason = plan_consolidation(
                sim, sched.cache, util_threshold=0.3, max_nodes_per_plan=2
            )
            assert plan is None and reason == "gang_strand"
            assert metrics.counter("descheduler_plan_rejected_total", strand) > strands0
            time.sleep(0.2)
            assert not deletions
            assert not store.get("nodes", "", "defrag-l0").spec.unschedulable
        finally:
            w.stop()
    finally:
        sched.stop()


def test_mid_plan_gang_change_aborts_and_rolls_back():
    store = ChaosStore()
    _gang_fleet(store, quorum=2)
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, 8)
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.3, max_nodes_per_plan=1
        )
        assert plan is not None, f"no plan: {reason}"
        assert plan.nodes == ["defrag-l0"]
        ex = PlanExecutor(store, sched, sim, EvictionBudget(100.0, 50))
        ex.adopt(plan)
        store.delete("pods", "default", "g-h0")
        assert wait_until(lambda: _cache_pods(sched) == 7, 15)
        evictions0 = metrics.counter("descheduler_evictions_total")
        assert ex.tick() is False
        assert metrics.counter(
            "descheduler_plan_aborts_total", {"reason": "gang_change"}
        ) >= 1
        assert metrics.counter("descheduler_evictions_total") == evictions0
        assert get_or_none(store, "pods", "default", "g-l0") is not None
        assert get_or_none(store, "pods", "default", "g-l1") is not None
        node = store.get("nodes", "", "defrag-l0")
        assert not node.spec.unschedulable
        assert ANN_DEFRAG not in node.metadata.annotations
    finally:
        sched.stop()


def _two_heavy_one_light(store):
    for name in ("defrag-h0", "defrag-h1", "defrag-l0"):
        store.create("nodes", make_node(name))
    n, victims = 0, []
    for i in range(2):
        for _ in range(5):
            store.create("pods", make_bound_pod(f"p{n}", f"defrag-h{i}"))
            n += 1
    for _ in range(4):
        store.create("pods", make_bound_pod(f"p{n}", "defrag-l0"))
        victims.append(f"p{n}")
        n += 1
    return n, victims


def _run_out(ex, timeout=60):
    deadline = time.monotonic() + timeout
    while ex.active and time.monotonic() < deadline:
        ex.tick()
        time.sleep(0.05)


def test_degraded_store_pauses_wave_and_resumes_after_recovery():
    store = ChaosStore()
    n, _victims = _two_heavy_one_light(store)
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, n)
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.55, max_nodes_per_plan=1
        )
        assert plan is not None, f"no plan: {reason}"
        assert plan.nodes == ["defrag-l0"]
        ex = PlanExecutor(store, sched, sim, EvictionBudget(100.0, 50))
        ex.adopt(plan)
        store.degrade()
        cordon = {"write": "cordon"}
        skips0 = metrics.counter("descheduler_degraded_write_skips_total", cordon)
        assert ex.tick() is True
        assert metrics.counter("descheduler_degraded_write_skips_total", cordon) > skips0
        assert ex.active, "degraded store must pause, not abort"
        assert store.count("pods") == n, "evicted against a read-only store"
        store.recover()
        _run_out(ex)
        assert not ex.active, "plan never completed after recovery"
        assert metrics.counter("descheduler_plans_completed_total") >= 1
        assert get_or_none(store, "nodes", "", "defrag-l0") is None
        assert metrics.counter("descheduler_evictions_total") >= 4
        assert_bind_invariants(store, allow_deleted=True)
    finally:
        sched.stop()


def test_degraded_store_mid_wave_pauses_eviction_with_plan_latched():
    store = ChaosStore()
    n, _victims = _two_heavy_one_light(store)
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, n)
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.55, max_nodes_per_plan=1
        )
        assert plan is not None, f"no plan: {reason}"
        evictions0 = metrics.counter("descheduler_evictions_total")
        ex = PlanExecutor(store, sched, sim, EvictionBudget(0.001, 2))
        ex.adopt(plan)
        assert ex.tick() is True
        assert metrics.counter("descheduler_evictions_total") >= evictions0 + 2
        evicted_so_far = int(metrics.counter("descheduler_evictions_total"))
        assert ex.active
        store.degrade()
        ex.budget = EvictionBudget(100.0, 50)
        evict = {"write": "evict"}
        skips0 = metrics.counter("descheduler_degraded_write_skips_total", evict)
        assert wait_until(lambda: _cache_pods(sched) == n - 2, 15)
        assert ex.tick() is True
        assert metrics.counter("descheduler_degraded_write_skips_total", evict) > skips0
        assert ex.active, "mid-wave degradation must pause, not abort"
        assert int(metrics.counter("descheduler_evictions_total")) == evicted_so_far
        store.recover()
        _run_out(ex)
        assert not ex.active
        assert get_or_none(store, "nodes", "", "defrag-l0") is None
        assert_bind_invariants(store, allow_deleted=True)
    finally:
        sched.stop()


def test_fenced_descheduler_writes_nothing_and_sweep_adopts_cordons():
    store = ChaosStore()
    store.create("nodes", make_node("defrag-h0"))
    store.create("nodes", make_node("defrag-l0"))
    n = 0
    for node, count in (("defrag-h0", 5), ("defrag-l0", 2)):
        for _ in range(count):
            store.create("pods", make_bound_pod(f"p{n}", node))
            n += 1
    store.create("leases", Lease(
        metadata=v1.ObjectMeta(name="sched-lease", namespace="kube-system"),
        holder_identity="replica-a",
        lease_transitions=1,
    ))
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, n)
        sched._bind_fence = BindFence(
            namespace="kube-system", name="sched-lease", identity="replica-a",
            transitions=1,
        )
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.3, max_nodes_per_plan=1
        )
        assert plan is not None, f"no plan: {reason}"
        starved = EvictionBudget(0.001, 1)
        assert starved.try_acquire()
        ex = PlanExecutor(store, sched, sim, starved)
        ex.adopt(plan)
        assert ex.tick() is True
        node = store.get("nodes", "", "defrag-l0")
        assert node.spec.unschedulable
        assert node.metadata.annotations.get(ANN_DEFRAG) == "true"

        def takeover(cur):
            cur.holder_identity = "replica-b"
            cur.lease_transitions += 1
            return cur

        store.guaranteed_update("leases", "kube-system", "sched-lease", takeover)
        deletions = []
        w = watch_deletions(store, deletions)
        uncordons0 = metrics.counter("descheduler_rollback_uncordons_total")
        try:
            assert ex.tick() is False, "fenced plan must die immediately"
            assert metrics.counter("descheduler_plan_aborts_total", {"reason": "fenced"}) >= 1
            time.sleep(0.2)
            assert not deletions, f"zombie evicted: {deletions}"
            assert metrics.counter("descheduler_rollback_uncordons_total") == uncordons0
            node = store.get("nodes", "", "defrag-l0")
            assert node.spec.unschedulable, "zombie wrote an uncordon"
            assert node.metadata.annotations.get(ANN_DEFRAG) == "true"
            sched._bind_fence = BindFence(
                namespace="kube-system", name="sched-lease", identity="replica-b",
                transitions=2,
            )
            ex2 = PlanExecutor(store, sched, sim, EvictionBudget(100.0, 50))
            ex2.sweep(store.list("nodes")[0])
            node = store.get("nodes", "", "defrag-l0")
            assert not node.spec.unschedulable
            assert ANN_DEFRAG not in node.metadata.annotations
            assert metrics.counter("descheduler_rollback_uncordons_total") > uncordons0
            assert_bind_invariants(store)
        finally:
            w.stop()
    finally:
        sched.stop()


def test_eviction_budget_shared_across_three_actors_stays_under_envelope():
    qps, burst = 20.0, 10
    budget = EvictionBudget(qps=qps, burst=burst)
    granted = {"nodelifecycle": 0, "preemption": 0, "descheduler": 0}
    base = {
        a: metrics.counter("eviction_budget_acquired_total", {"actor": a})
        for a in granted
    }
    stop = threading.Event()

    def storm(actor):
        while not stop.is_set():
            if budget.try_acquire(actor=actor):
                granted[actor] += 1
            time.sleep(0.001)

    threads = [threading.Thread(target=storm, args=(a,), daemon=True) for a in granted]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=2.0)
    elapsed = time.monotonic() - t0
    total = sum(granted.values())
    ceiling = qps * elapsed + burst + 1
    assert total <= ceiling, f"{total} grants > {ceiling:.1f} ({granted})"
    assert total >= burst + qps * elapsed * 0.5, f"budget starved: {total} ({granted})"
    deltas = {
        a: metrics.counter("eviction_budget_acquired_total", {"actor": a}) - base[a]
        for a in granted
    }
    assert sum(int(d) for d in deltas.values()) == total
    for actor, got in granted.items():
        assert deltas[actor] == float(got)


def test_stale_pdb_column_never_admits_budget_violating_eviction():
    store = ChaosStore()
    store.create("nodes", make_node("defrag-h0"))
    store.create("nodes", make_node("defrag-l0"))
    n = 0
    for _ in range(5):
        store.create("pods", make_bound_pod(f"p{n}", "defrag-h0"))
        n += 1
    for i in range(2):
        store.create("pods", make_bound_pod(f"web-{i}", "defrag-l0", labels={"app": "web"}))
        n += 1
    store.create(
        "poddisruptionbudgets",
        v1.PodDisruptionBudget(
            metadata=v1.ObjectMeta(name="web-pdb"),
            spec=v1.PodDisruptionBudgetSpec(min_available=1, selector={"app": "web"}),
            status=v1.PodDisruptionBudgetStatus(disruptions_allowed=1),
        ),
    )
    sched = _started_scheduler(store)
    try:
        _wait_cache(sched, n)
        sim = WhatIfSimulator(sched.cache)
        plan, reason = plan_consolidation(
            sim, sched.cache, util_threshold=0.3, max_nodes_per_plan=1
        )
        assert plan is not None, f"no plan: {reason}"
        assert plan.nodes == ["defrag-l0"]
        ex = PlanExecutor(store, sched, sim, EvictionBudget(100.0, 50))
        ex.adopt(plan)
        pauses0 = metrics.counter("descheduler_pdb_wave_pauses_total")
        evictions0 = metrics.counter("descheduler_evictions_total")
        assert ex.tick() is True, "exhausted budget must pause, not abort"
        assert metrics.counter("descheduler_evictions_total") == evictions0 + 1
        assert metrics.counter("descheduler_pdb_wave_pauses_total") > pauses0
        web = [p for p in store.list("pods")[0] if p.metadata.labels.get("app") == "web"]
        assert len(web) == 1, "min_available=1 violated: both victims gone"
        assert ex.active, "plan must stay latched for the budget refill"

        def refresh(cur):
            cur.status.disruptions_allowed = 1
            return cur

        store.guaranteed_update("poddisruptionbudgets", "default", "web-pdb", refresh)
        _run_out(ex)
        assert not ex.active
        assert get_or_none(store, "nodes", "", "defrag-l0") is None
        assert_bind_invariants(store, allow_deleted=True)
    finally:
        sched.stop()


def test_eviction_gate_matches_host_pdb_oracle_differentially():
    rng = random.Random(1219)
    store = ChaosStore()
    label_pool = [{"app": "a"}, {"app": "b"}, {"app": "a", "tier": "db"}, {}]
    pods = []
    for i in range(16):
        labels = dict(rng.choice(label_pool))
        name = f"dp-{i}"
        store.create("pods", make_bound_pod(name, "defrag-h0", labels=labels))
        pods.append((name, labels))
    budgets = {}
    for j, sel in enumerate([{"app": "a"}, {"tier": "db"}, {}]):
        allowed = rng.choice([0, 1, 3])
        name = f"pdb-{j}"
        store.create(
            "poddisruptionbudgets",
            v1.PodDisruptionBudget(
                metadata=v1.ObjectMeta(name=name),
                spec=v1.PodDisruptionBudgetSpec(selector=dict(sel)),
                status=v1.PodDisruptionBudgetStatus(disruptions_allowed=allowed),
            ),
        )
        budgets[name] = [dict(sel), allowed]
    order = list(pods)
    rng.shuffle(order)
    for name, labels in order:
        covering = [b for b in budgets.values() if match_labels(b[0], labels)]
        oracle_admits = all(b[1] > 0 for b in covering)
        try:
            store.evict_pod("default", name)
            admitted = True
        except TooManyRequests:
            admitted = False
        assert admitted == oracle_admits, (name, labels, budgets)
        if admitted:
            for b in covering:
                b[1] -= 1
    for name, (_sel, allowed) in budgets.items():
        pdb = store.get("poddisruptionbudgets", "default", name)
        assert pdb.status.disruptions_allowed == allowed, name
