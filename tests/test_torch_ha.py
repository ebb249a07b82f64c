"""The port's Scheduler HA (leader election, the lease fence, the bind
ride-through buffer, promotion and adoption) against the reference, on the
CPU (the port at device="cpu").

Every case runs one scenario on both packages, each over its own store,
and compares the outcomes; each run is also held to the reference test's
own assertions.

(a) The Scheduler-driving scenarios of tests/test_chaos_ha.py: the
    standby warm-up, the leader killed mid-wave (its binds parked in the
    ride-through buffer) with the standby adopting and binding every pod
    once, the paused ex-leader's late binds fenced while the new leader
    binds a racing burst once each, the graceful stop handing the lease
    over in retry periods, a standby killed with the leader unaffected,
    one store watch per kind for two replicas, the per-pod plugin bind
    fenced, and the failover adopting the persisted score policy.
    Compared: binds exactly once on the bind ledger (``ChaosStore``),
    adoption outcome counts, fence refusals, lease holder and
    transitions, watch counts, the adopted policy.
(b) The reference's leader-election edge cases (fake clocks, no
    Scheduler) on both packages' copies: every grant, refusal and lease
    field equal.
(c) The Scheduler ride-through scenarios of tests/test_chaos_pipeline.py:
    a degraded store mid-wave then drained, a quorum lost mid-bind with
    no double bind, degrade/recover cycles. Compared: bound counts,
    breaker and buffer gauges, reconciled outcomes, evictions.
(d) One deterministic adoption: both packages' standbys hold the same
    queue over the same store state, in which the dead leader's last wave
    left some binds landed, some pods deleted and the rest parked
    (never bound). The standbys' informers are stopped first, as if they
    lagged the dead leader's last writes, so every standby sees the same
    three kinds of pod at promotion. Each is promoted with no elector
    thread, the port fed the reference's tie noise: the adoption outcome
    counts are equal, and so are the placements, or the chosen nodes
    differ only inside a near-tie (``assert_tie_only``).

Tolerances: exact counts and sets; wall-clock budgets are the reference
test's own (the first bind after the kill within one autoscaler period).
"""

import collections
import importlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

import test_chaos_pipeline as ref_chaos
import test_torch_autoscaler as port_chaos
from test_torch_scheduler import _parity_servers, _Recorder
from test_torch_wavelattice import assert_tie_only

REF, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"

# tests/test_chaos_ha.py's budget for the first bind after the kill: one
# autoscaler period
AUTOSCALER_PERIOD_S = 5.0


class _Pkg:
    """One package's HA surface, its ChaosStore and its Scheduler (the
    port's on the CPU)."""

    def __init__(self, pkg):
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")
        self.pkg = pkg
        self.v1 = imp("api.objects")
        apiserver = imp("client.apiserver")
        self.APIServer, self.LeaderFenced = apiserver.APIServer, apiserver.LeaderFenced
        le = imp("client.leaderelection")
        self.LeaderElectionConfig, self.LeaderElector = le.LeaderElectionConfig, le.LeaderElector
        self.Cacher = imp("apiserver.cacher").Cacher
        self.NodeAgentPool = imp("kubelet.kubelet").NodeAgentPool
        self.lifecycle = imp("controller.nodelifecycle")
        self.DegradedWrites = imp("runtime.consensus").DegradedWrites
        sched = imp("scheduler")
        self._Scheduler, self.Config = sched.Scheduler, sched.KubeSchedulerConfiguration
        self.QueuedPodInfo = imp("scheduler.queue.scheduling_queue").QueuedPodInfo
        self.CycleState = imp("scheduler.framework.interface").CycleState
        self.metrics = imp("utils.metrics").metrics
        self.lockgraph = imp("testing.lockgraph")
        self.tuner = imp("tuner")
        self.lattice = imp("ops.lattice")
        chaos = ref_chaos if pkg == REF else port_chaos
        self.ChaosStore = chaos.ChaosStore
        self.assert_bind_invariants = chaos.assert_bind_invariants

    def scheduler(self, server, cfg=None, **kw):
        if self.pkg == PORT:
            kw.setdefault("device", "cpu")
        return self._Scheduler(server, cfg or self.Config(), **kw)

    def pod(self, name, **spec):
        v1 = self.v1
        spec.setdefault("containers", [v1.Container(requests={"cpu": "100m"})])
        return v1.Pod(metadata=v1.ObjectMeta(name=name), spec=v1.PodSpec(**spec))

    def node(self, name):
        v1 = self.v1
        res = {"cpu": "8", "memory": "16Gi", "pods": "110"}
        return v1.Node(
            metadata=v1.ObjectMeta(name=name),
            status=v1.NodeStatus(capacity=dict(res), allocatable=dict(res)),
        )

    def lease_cfg(self, identity, **kw):
        """tests/test_chaos_ha.py's fast-failover lease unless `kw` says."""
        kw.setdefault("lease_duration", 1.5)
        kw.setdefault("renew_deadline", 1.0)
        kw.setdefault("retry_period", 0.2)
        return self.LeaderElectionConfig(identity=identity, **kw)

    def counter(self, name, labels=None):
        return self.metrics.counter(name, labels)


PKGS = {p: _Pkg(p) for p in (REF, PORT)}


def both(scenario, *args):
    """Run `scenario(pkg, *args)` on the reference, then on the port, and
    return the two outcomes."""
    return scenario(PKGS[REF], *args), scenario(PKGS[PORT], *args)


wait_until, bound_count = ref_chaos.wait_until, ref_chaos._bound_count


@pytest.fixture(autouse=True, scope="module")
def lock_order_watchdog():
    """tests/test_chaos_ha.py's lock-order watchdog and lockset sanitizer,
    on both packages: leader, standby and zombie replicas share one store
    and one watch cache from different threads."""
    graphs = [PKGS[p].lockgraph for p in (REF, PORT)]
    for g in graphs:
        g.enable(eraser=True)
    yield
    try:
        for g in graphs:
            g.assert_clean()
            assert g.acquire_count() > 0, "no named-lock acquisitions observed"
            assert g.tracked_access_count() > 0, "no tracked-attribute accesses observed"
    finally:
        for g in graphs:
            g.disable()


@pytest.fixture(autouse=True)
def _metrics_left_as_found():
    """Both packages' metrics are process-wide and these scenarios read
    them as deltas: put every counter, gauge and histogram back as it was,
    so that a later test in the same process that reads one absolutely
    (tests/test_preemptlattice.py does) sees what it would have seen."""
    saved = []
    for p in (REF, PORT):
        m = PKGS[p].metrics
        with m._lock:
            saved.append((m, dict(m._counters), dict(m._gauges), dict(m._hists)))
    yield
    for m, *before in saved:
        with m._lock:
            for live, old in zip((m._counters, m._gauges, m._hists), before):
                live.clear()
                live.update(old)


class _Replica:
    """One scheduler replica wired as tests/test_chaos_ha.py's _Replica
    (and cmd/scheduler.py) wire it: a Scheduler standing by over the shared
    watch cache, its elector on the raw store, and the election winner
    promoting with the elector's fence."""

    def __init__(self, pkg, store, cacher, identity, lease_cfg=None):
        self.identity = identity
        self.sched = pkg.scheduler(cacher)
        self.sched.start_standby(identity=identity)
        self.promoted = threading.Event()
        self.deposed = threading.Event()

        def on_started():
            self.sched.promote(fence=self.elector.fence())
            self.promoted.set()

        self.elector = pkg.LeaderElector(
            store, lease_cfg or pkg.lease_cfg(identity),
            on_started_leading=on_started, on_stopped_leading=self.deposed.set,
        )
        self._thread = threading.Thread(
            target=self.elector.run, daemon=True, name=f"elector-{identity}"
        )
        self._thread.start()

    def stop(self):
        self.elector.stop()
        self.sched.stop()

    def crash(self):
        """Leader death: no lease release, the scheduling threads stopped
        with whatever was mid-flight left dangling in the store."""
        self.elector.crash()
        self.sched.stop()


def _cluster(pkg, n_nodes=6):
    store = pkg.ChaosStore()
    cacher = pkg.Cacher(store)
    pool = pkg.NodeAgentPool(store, housekeeping_interval=0.1)
    for i in range(n_nodes):
        pool.add_node(f"ha-{i}")
    pool.start()
    return store, cacher, pool


def _lease(server):
    """The scheduler lease's holder and transitions."""
    lease = server.get("leases", "kube-system", "kube-scheduler")
    return lease.holder_identity, int(lease.lease_transitions)


ADOPTIONS = ("bound", "pending", "gone")


def _adoptions(pkg):
    return [pkg.counter("scheduler_ha_adoptions_total", {"outcome": o}) for o in ADOPTIONS]


def _delta(after, before):
    return [a - b for a, b in zip(after, before)]


def _create_riding(pkg, store, names):
    """Create a pod per name; once the armed bind refusal has degraded the
    store (the leader may bind the first pods before the rest are created,
    as in the reference test under load), the remaining creates are
    refused too: return those names, for the caller to create after
    recover()."""
    for i, name in enumerate(names):
        try:
            store.create("pods", pkg.pod(name))
        except pkg.DegradedWrites:
            return names[i:]
    return []


def _applied_once(store):
    return bool(store.applied_binds) and all(c == 1 for c in store.applied_binds.values())


# -- (a) tests/test_chaos_ha.py's Scheduler-driving scenarios ------------------


def _warmup(pkg):
    store, cacher, pool = _cluster(pkg)
    w0, a0 = pkg.counter("scheduler_ha_standby_warmups_total"), _adoptions(pkg)
    sched = pkg.scheduler(cacher)
    sched.start_standby(identity="warmup")
    try:
        warmups = pkg.counter("scheduler_ha_standby_warmups_total") - w0
        for i in range(30):
            store.create("pods", pkg.pod(f"wu-{i}"))
        assert wait_until(lambda: len(sched.queue) == 30, 30)
        sched.promote()
        assert wait_until(lambda: bound_count(store) == 30, 60)
        return {"warmups": warmups, "adoptions": _delta(_adoptions(pkg), a0),
                "bound": bound_count(store), "once": _applied_once(store)}
    finally:
        sched.stop()
        pool.stop()
        cacher.stop()


def test_warmup_compile_ha_absorber_matches_reference():
    """The reference suite's warm-up (a standby that pre-warms, 30 pods
    queued while it stands by, promote): it also absorbs this process's
    first kernel launches at the suite's shapes on both packages."""
    ref, port = both(_warmup)
    assert ref == port == {
        "warmups": 1.0, "adoptions": [0.0, 30.0, 0.0], "bound": 30, "once": True,
    }


def _kill_mid_wave(pkg):
    store, cacher, pool = _cluster(pkg)
    a = _Replica(pkg, store, cacher, "ha-leader-a")
    assert wait_until(a.promoted.is_set, 15), "first replica never led"
    b = _Replica(pkg, store, cacher, "ha-standby-b")
    try:
        n1 = n2 = 30
        for i in range(n1):
            store.create("pods", pkg.pod(f"pre-{i}"))
        assert wait_until(lambda: bound_count(store) == n1, 30)
        # the next wave's bulk bind is refused (degraded store): the leader
        # parks it assumed-but-unbound, then dies before the buffer drains
        store.fail_next_bind = "degraded"
        late = _create_riding(pkg, store, [f"wave-{i}" for i in range(n2)])
        assert wait_until(lambda: a.sched._ridethrough.depth > 0, 15), (
            "leader never parked the mid-flight wave"
        )
        depth = a.sched._ridethrough.depth
        bound_at_kill = bound_count(store)
        assert bound_at_kill < n1 + n2
        a0 = _adoptions(pkg)
        t_kill = time.monotonic()
        a.crash()
        store.recover()
        for name in late:
            store.create("pods", pkg.pod(name))
        assert wait_until(b.promoted.is_set, 15), "standby never promoted"
        assert wait_until(lambda: bound_count(store) > bound_at_kill, 15), (
            "no bind ever landed after the kill"
        )
        t_first = time.monotonic() - t_kill
        assert t_first < AUTOSCALER_PERIOD_S, t_first
        assert wait_until(lambda: bound_count(store) == n1 + n2, 30)
        adopted = _delta(_adoptions(pkg), a0)
        assert adopted[1] > 0, "promotion ran no adoption pass over the wave"
        pkg.assert_bind_invariants(store)
        return {
            "parked": depth > 0,
            # every pod unbound at the kill was adopted as pending
            "adopted": [adopted[0], adopted[1] - (n1 + n2 - bound_at_kill), adopted[2]],
            "bound": bound_count(store), "once": _applied_once(store),
            "lease": _lease(store), "first_bind_in_budget": t_first < AUTOSCALER_PERIOD_S,
        }
    finally:
        b.stop()
        a.stop()
        pool.stop()
        cacher.stop()


def test_kill_leader_mid_wave_standby_adopts_and_binds_like_reference():
    ref, port = both(_kill_mid_wave)
    assert port == ref == {
        "parked": True, "adopted": [0.0, 0.0, 0.0], "bound": 60, "once": True,
        "lease": ("ha-standby-b", 1), "first_bind_in_budget": True,
    }


def _zombie(pkg):
    store, cacher, pool = _cluster(pkg)
    a = _Replica(pkg, store, cacher, "zombie-a")
    assert wait_until(a.promoted.is_set, 15)
    b = _Replica(pkg, store, cacher, "fresh-b")
    try:
        for i in range(10):
            store.create("pods", pkg.pod(f"pre-z-{i}"))
        assert wait_until(lambda: bound_count(store) == 10, 30)
        # pause: the elector stops renewing without releasing, the zombie's
        # Scheduler keeps running
        a.elector.crash()
        assert wait_until(b.promoted.is_set, 15), "standby never took over"
        zp = store.create("pods", pkg.pod("zombie-target", scheduler_name="nobody"))
        binding = pkg.v1.Binding(
            pod_name="zombie-target", pod_namespace="default",
            pod_uid=zp.metadata.uid, target_node="ha-0",
        )
        with pytest.raises(pkg.LeaderFenced):
            a.sched._bind_pods_fenced([binding])
        fenced_unbound = not store.get("pods", "default", "zombie-target").spec.node_name
        for i in range(20):
            store.create("pods", pkg.pod(f"race-{i}"))
        assert wait_until(
            lambda: store.count(
                "pods", lambda p: p.metadata.name.startswith("race-") and bool(p.spec.node_name)
            ) == 20,
            30,
        ), "racing burst never fully bound after the takeover"
        pkg.assert_bind_invariants(store)
        return {"fenced_unbound": fenced_unbound, "once": _applied_once(store),
                "bound": bound_count(store), "lease": _lease(store)}
    finally:
        b.stop()
        a.stop()
        pool.stop()
        cacher.stop()


def test_zombie_ex_leader_late_binds_are_fenced_like_reference():
    ref, port = both(_zombie)
    assert port == ref == {
        "fenced_unbound": True, "once": True, "bound": 30, "lease": ("fresh-b", 1),
    }


def _graceful(pkg):
    store, cacher, pool = _cluster(pkg)
    # a long lease: an expiry-driven handoff could not beat 3 s
    long = dict(lease_duration=8.0, renew_deadline=5.0, retry_period=0.3)
    a = _Replica(pkg, store, cacher, "old", lease_cfg=pkg.lease_cfg("old", **long))
    assert wait_until(a.promoted.is_set, 15)
    b = _Replica(pkg, store, cacher, "new", lease_cfg=pkg.lease_cfg("new", **long))
    try:
        rel0 = pkg.counter("leader_election_releases_total")
        t0 = time.monotonic()
        a.stop()  # graceful: releases the lease
        assert wait_until(b.promoted.is_set, 15), "standby never promoted"
        elapsed = time.monotonic() - t0
        assert elapsed < 3.0, f"handoff took {elapsed:.2f}s"
        for i in range(10):
            store.create("pods", pkg.pod(f"rolled-{i}"))
        assert wait_until(lambda: bound_count(store) == 10, 30)
        pkg.assert_bind_invariants(store)
        return {"released": pkg.counter("leader_election_releases_total") - rel0,
                "fast": elapsed < 3.0, "lease": _lease(store), "bound": bound_count(store)}
    finally:
        b.stop()
        a.stop()
        pool.stop()
        cacher.stop()


def test_graceful_stop_releases_lease_fast_handoff_like_reference():
    ref, port = both(_graceful)
    assert port == ref == {"released": 1.0, "fast": True, "lease": ("new", 2), "bound": 10}


def _standby_killed(pkg):
    store, cacher, pool = _cluster(pkg)
    a = _Replica(pkg, store, cacher, "solo-leader")
    assert wait_until(a.promoted.is_set, 15)
    b = _Replica(pkg, store, cacher, "doomed-standby")
    try:
        b.crash()
        for i in range(15):
            store.create("pods", pkg.pod(f"after-sb-{i}"))
        assert wait_until(lambda: bound_count(store) == 15, 30)
        pkg.assert_bind_invariants(store)
        return {"leading": a.elector.is_leader, "standby_promoted": b.promoted.is_set(),
                "once": _applied_once(store), "lease": _lease(store)}
    finally:
        a.stop()
        b.stop()
        pool.stop()
        cacher.stop()


def test_standby_killed_leader_unaffected_like_reference():
    ref, port = both(_standby_killed)
    assert port == ref == {
        "leading": True, "standby_promoted": False, "once": True, "lease": ("solo-leader", 0),
    }


def _watches(pkg):
    store = pkg.ChaosStore()
    cacher = pkg.Cacher(store)
    for i in range(3):
        store.create("nodes", pkg.node(f"w-{i}"))
    kinds = ("pods", "nodes", "services")
    base = {k: store.watcher_count(k) for k in kinds}
    a, b = pkg.scheduler(cacher), pkg.scheduler(cacher)
    try:
        a.start_standby(identity="watch-a")
        b.start_standby(identity="watch-b")
        return {
            k: (store.watcher_count(k) - base[k], cacher.cache_for(k).fanout_clients() >= 2)
            for k in kinds
        }
    finally:
        a.stop()
        b.stop()
        cacher.stop()


def test_ha_replicas_share_one_store_watch_per_kind_like_reference():
    ref, port = both(_watches)
    assert port == ref == {k: (1, True) for k in ("pods", "nodes", "services")}


def _plugin_fenced(pkg):
    store, cacher, pool = _cluster(pkg)
    a = _Replica(pkg, store, cacher, "plugin-zombie-a")
    assert wait_until(a.promoted.is_set, 15)
    b = _Replica(pkg, store, cacher, "plugin-fresh-b")
    try:
        a.elector.crash()
        assert wait_until(b.promoted.is_set, 15), "standby never took over"
        zp = store.create("pods", pkg.pod(
            "plugin-zombie-target", node_selector={"no-such-label": "nowhere"}
        ))
        unbound = lambda: not store.get("pods", "default", "plugin-zombie-target").spec.node_name
        out = {}
        # (1) DefaultBinder through the framework's fenced bind surface
        prof = a.sched.profiles.for_pod(zp)
        with pytest.raises(pkg.LeaderFenced):
            prof.framework.run_bind_plugins(pkg.CycleState(), zp, "ha-0")
        out["plugin_unbound"] = unbound()
        # (2) the whole async binding cycle: dropped and counted
        key = "scheduler_ha_fenced_binds_total{'path': 'local'}"
        before = pkg.metrics.dump().get(key, 0.0)
        a.sched.cache.assume_pod(zp, "ha-0", device_synced=False)
        a.sched._bind_async(pkg.QueuedPodInfo(pod=zp), "ha-0", pkg.CycleState(), time.monotonic())
        out["cycle_unbound"] = unbound()
        out["fenced_local"] = pkg.metrics.dump().get(key, 0.0) - before
        # (3) the extender pre-check seam
        with pytest.raises(pkg.LeaderFenced):
            a.sched._check_fence_live()
        pkg.assert_bind_invariants(store)
        out["lease"] = _lease(store)
        return out
    finally:
        b.stop()
        a.stop()
        pool.stop()
        cacher.stop()


def test_plugin_per_pod_bind_path_is_fenced_like_reference():
    ref, port = both(_plugin_fenced)
    assert port == ref == {
        "plugin_unbound": True, "cycle_unbound": True, "fenced_local": 1.0,
        "lease": ("plugin-fresh-b", 1),
    }


def _policy_failover(pkg):
    lat = pkg.lattice
    store, cacher, pool = _cluster(pkg, n_nodes=2)
    vec = lat.DEFAULT_WEIGHTS.copy()
    vec[lat.SC_COST] = 21.0
    assert pkg.tuner.persist_active_policy(store, "t-ha-tuned", vec, identity="gym")
    a = b = None
    key = "tuner_policy_adoptions_total{'outcome': 'adopted'}"
    try:
        a = _Replica(pkg, store, cacher, "adopt-a")
        assert a.promoted.wait(20), "replica A never won the election"
        a_policy = (a.sched._score_policy_name, bool(np.allclose(np.asarray(a.sched._weights), vec)))
        b = _Replica(pkg, store, cacher, "adopt-b")
        adopted0 = pkg.metrics.dump().get(key, 0.0)
        a.crash()
        assert b.promoted.wait(30), "standby never took over the lease"
        obj = store.get("scorepolicies", "", pkg.tuner.ACTIVE_POLICY_NAME)
        pkg.assert_bind_invariants(store)
        return {
            "a": a_policy,
            "b": (b.sched._score_policy_name, bool(np.allclose(np.asarray(b.sched._weights), vec))),
            "adopted": pkg.metrics.dump().get(key, 0.0) - adopted0 >= 1,
            # adoption reads the persisted object, never writes it
            "object": (obj.policy_name, int(obj.promotions),
                       [float(x) for x in obj.weights] == [float(x) for x in vec]),
            "lease": _lease(store),
        }
    finally:
        if b is not None:
            b.stop()
        if a is not None:
            a.stop()
        pool.stop()
        cacher.stop()
        lat.WEIGHT_PROFILES.pop("t-ha-tuned", None)


def test_failover_adopts_persisted_score_policy_like_reference():
    ref, port = both(_policy_failover)
    assert port == ref == {
        "a": ("t-ha-tuned", True), "b": ("t-ha-tuned", True), "adopted": True,
        "object": ("t-ha-tuned", 1, True), "lease": ("adopt-b", 1),
    }


# -- (b) the leader-election edge cases (fake clocks, no Scheduler) ------------


def _electors(pkg, start=0.0):
    """An APIServer, its fake clock and a maker of electors on both, with
    tests/test_chaos_ha.py's edge-case lease (3 s, renew 2 s, retry 50 ms)."""
    s, now = pkg.APIServer(), [start]

    def elector(name):
        cfg = pkg.lease_cfg(name, lease_duration=3.0, renew_deadline=2.0, retry_period=0.05)
        return pkg.LeaderElector(s, cfg, lambda: None, clock=lambda: now[0])

    return s, now, elector


def _expired_takeover(pkg):
    s, now, elector = _electors(pkg)
    e1, e2 = elector("one"), elector("two")
    out = [e1._try_acquire_or_renew(), _lease(s), e2._try_acquire_or_renew()]
    now[0] += 10.0  # past lease_duration
    out += [e2._try_acquire_or_renew(), _lease(s), e1._try_acquire_or_renew()]
    return out


def test_expired_lease_takeover_bumps_transitions_once_like_reference():
    ref, port = both(_expired_takeover)
    assert port == ref == [True, ("one", 0), False, True, ("two", 1), False]


def _single_grant(pkg):
    s, now, elector = _electors(pkg)
    assert elector("seed")._try_acquire_or_renew()
    now[0] += 10.0
    n = 8
    electors = [elector(f"cand-{i}") for i in range(n)]
    results = [None] * n
    barrier = threading.Barrier(n)

    def race(i):
        barrier.wait()
        results[i] = electors[i]._try_acquire_or_renew()

    threads = [threading.Thread(target=race, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5.0)
    holder, transitions = _lease(s)
    return {"grants": sum(1 for r in results if r), "transitions": transitions,
            "holder_is_candidate": holder.startswith("cand-")}


def test_concurrent_candidates_single_grant_per_transition_like_reference():
    ref, port = both(_single_grant)
    assert port == ref == {"grants": 1, "transitions": 1, "holder_is_candidate": True}


def _same_identity(pkg):
    s, now, elector = _electors(pkg)
    old = elector("static-id")
    assert old._try_acquire_or_renew()
    stale = old.fence()
    now[0] += 10.0
    new = elector("static-id")
    out = [new._try_acquire_or_renew(), _lease(s), new.fence().transitions]
    s.create("nodes", pkg.node("fz-1"))
    p = s.create("pods", pkg.pod("fz-pod"))
    binding = pkg.v1.Binding(pod_name="fz-pod", pod_namespace="default",
                             pod_uid=p.metadata.uid, target_node="fz-1")
    with pytest.raises(pkg.LeaderFenced):
        s.bind_pods([binding], fence=stale)
    return out + [s.bind_pods([binding], fence=new.fence())]


def test_same_identity_reacquire_after_expiry_mints_fresh_fence_like_reference():
    ref, port = both(_same_identity)
    assert port == ref == [True, ("static-id", 1), 1, [None]]


def _renew_deadline_fatal(pkg):
    store, stopped = pkg.ChaosStore(), threading.Event()
    cfg = pkg.lease_cfg("fatal", lease_duration=1.2, renew_deadline=0.8, retry_period=0.15)
    el = pkg.LeaderElector(store, cfg, on_started_leading=lambda: None,
                           on_stopped_leading=stopped.set)
    t = threading.Thread(target=el.run, daemon=True)
    t.start()
    try:
        assert wait_until(lambda: el.is_leader, 5)
        skips0 = pkg.counter("leader_election_degraded_renew_skips_total")
        store.degrade()
        deposed = stopped.wait(5.0)
        return {"deposed": deposed, "leading": el.is_leader,
                "skips": pkg.counter("leader_election_degraded_renew_skips_total") > skips0}
    finally:
        store.recover()
        el.stop()
        t.join(5.0)


def test_renew_deadline_loss_is_fatal_like_reference():
    ref, port = both(_renew_deadline_fatal)
    assert port == ref == {"deposed": True, "leading": False, "skips": True}


def _degraded_renew(pkg):
    store, stopped = pkg.ChaosStore(), threading.Event()
    cfg = pkg.lease_cfg("rider", lease_duration=3.0, renew_deadline=2.0, retry_period=0.1)
    el = pkg.LeaderElector(store, cfg, on_started_leading=lambda: None,
                           on_stopped_leading=stopped.set)
    t = threading.Thread(target=el.run, daemon=True)
    t.start()
    try:
        assert wait_until(lambda: el.is_leader, 5)
        skips0 = pkg.counter("leader_election_degraded_renew_skips_total")
        store.degrade()
        time.sleep(0.5)  # several refused renews, well inside the deadline
        store.recover()
        skips = pkg.counter("leader_election_degraded_renew_skips_total") > skips0
        time.sleep(0.4)  # a healthy renew lands
        return {"skips": skips, "leading": el.is_leader, "deposed": stopped.is_set()}
    finally:
        el.stop()
        t.join(5.0)


def test_degraded_renew_within_deadline_keeps_leading_like_reference():
    ref, port = both(_degraded_renew)
    assert port == ref == {"skips": True, "leading": True, "deposed": False}


def _jittered(pkg):
    import random

    s, now, elector = _electors(pkg, start=100.0)
    holder, chall = elector("holder"), elector("chall")
    rng = random.Random(42)
    out = [holder._try_acquire_or_renew()]
    for _ in range(40):
        now[0] += rng.uniform(0.2, 2.8)  # always inside lease_duration
        out += [chall._try_acquire_or_renew(), holder._try_acquire_or_renew()]
    out.append(_lease(s))
    now[0] += 3.5  # the holder goes silent
    return out + [chall._try_acquire_or_renew(), _lease(s)]


def test_clock_jittered_renew_races_never_steal_a_live_lease_like_reference():
    ref, port = both(_jittered)
    assert port == ref
    assert port == [True] + [False, True] * 40 + [("holder", 0), True, ("chall", 1)]


# -- (c) tests/test_chaos_pipeline.py's Scheduler ride-through scenarios -------


def _watch_deletions(store, sink):
    w = store.watch("pods")

    def drain():
        for ev in w:
            if ev.type == "DELETED":
                sink.append(ev.object.metadata.key)

    threading.Thread(target=drain, daemon=True).start()
    return w


def _degrade_mid_wave(pkg):
    m = pkg.metrics
    store = pkg.ChaosStore()
    pool = pkg.NodeAgentPool(store, heartbeat_interval=0.2, housekeeping_interval=0.1)
    for i in range(8):
        pool.add_node(f"node-{i}")
    nlc = pkg.lifecycle.NodeLifecycleController(
        store, node_monitor_period=0.1, node_monitor_grace_period=0.8,
        pod_eviction_timeout=0.3,
    )
    n = 60
    for i in range(n):
        store.create("pods", pkg.pod(f"wave-{i}"))
    deletions = []
    w = _watch_deletions(store, deletions)
    store.fail_next_bind = "degraded"
    sched = pkg.scheduler(store)
    pool.start()
    sched.start()
    nlc.start()
    try:
        assert wait_until(lambda: m.gauge("scheduler_bind_breaker_state") == 1.0, 15), (
            "breaker never opened on the degraded bind"
        )
        out = {"bound_while_degraded": bound_count(store),
               "buffered": m.gauge("scheduler_pending_binds") >= 1}
        assert wait_until(lambda: m.gauge(pkg.lifecycle.GAUGE_PARTIAL_DISRUPTION) == 1.0, 15), (
            "partial-disruption mode never armed during the outage"
        )
        out["bound_after_halt"] = bound_count(store)
        store.recover()
        t0 = time.monotonic()
        assert wait_until(lambda: bound_count(store) == n, 15)
        assert wait_until(
            lambda: m.gauge("scheduler_pending_binds") == 0.0
            and m.gauge("scheduler_bind_breaker_state") == 0.0,
            5,
        ), "pending-bind buffer never drained / breaker never closed"
        elapsed = time.monotonic() - t0
        assert elapsed <= 5.0, elapsed
        pkg.assert_bind_invariants(store)
        untainted = wait_until(lambda: all(not nd.spec.taints for nd in store.list("nodes")[0]), 15)
        out.update(bound=bound_count(store), drained_in_budget=elapsed <= 5.0,
                   deletions=list(deletions), untainted=untainted, once=_applied_once(store))
        return out
    finally:
        nlc.stop()
        sched.stop()
        pool.stop()
        w.stop()


def test_degrade_store_mid_wave_then_recover_drains_buffer_like_reference():
    ref, port = both(_degrade_mid_wave)
    assert port == ref == {
        "bound_while_degraded": 0, "buffered": True, "bound_after_halt": 0, "bound": 60,
        "drained_in_budget": True, "deletions": [], "untainted": True, "once": True,
    }


def _quorum_lost(pkg):
    m = pkg.metrics
    store = pkg.ChaosStore()
    pool = pkg.NodeAgentPool(store, housekeeping_interval=0.1)
    for i in range(6):
        pool.add_node(f"node-{i}")
    n = 40
    for i in range(n):
        store.create("pods", pkg.pod(f"ql-{i}"))
    store.fail_next_bind = "quorum_lost"
    landed0 = pkg.counter("scheduler_bind_reconcile_total", {"outcome": "landed"})
    sched = pkg.scheduler(store)
    pool.start()
    sched.start()
    try:
        assert wait_until(lambda: m.gauge("scheduler_bind_breaker_state") == 1.0, 15)
        applied = sum(store.applied_binds.values())
        time.sleep(0.4)
        store.recover()
        assert wait_until(lambda: bound_count(store) == n, 15)
        assert wait_until(lambda: m.gauge("scheduler_pending_binds") == 0.0, 5)
        landed = pkg.counter("scheduler_bind_reconcile_total", {"outcome": "landed"}) - landed0
        pkg.assert_bind_invariants(store)
        return {"applied_before_ack_loss": applied >= 1, "landed": landed >= 1,
                "bound": bound_count(store), "once": _applied_once(store)}
    finally:
        sched.stop()
        pool.stop()


def test_quorum_lost_mid_bind_reconciles_without_double_bind_like_reference():
    ref, port = both(_quorum_lost)
    assert port == ref == {"applied_before_ack_loss": True, "landed": True, "bound": 40,
                           "once": True}


def _cycles(pkg):
    m = pkg.metrics
    store = pkg.ChaosStore()
    pool = pkg.NodeAgentPool(store, housekeeping_interval=0.1)
    for i in range(8):
        pool.add_node(f"soak-{i}")
    sched = pkg.scheduler(store)
    pool.start()
    sched.start()
    total, out = 0, []
    try:
        for cycle in range(4):
            store.fail_next_bind = "quorum_lost" if cycle % 2 else "degraded"
            late = _create_riding(pkg, store, [f"soak-c{cycle}-{i}" for i in range(50)])
            total += 50
            opened = wait_until(lambda: m.gauge("scheduler_bind_breaker_state") == 1.0, 15)
            time.sleep(0.3)
            store.recover()
            for name in late:
                store.create("pods", pkg.pod(name))
            assert wait_until(lambda: bound_count(store) == total, 20), (
                f"cycle {cycle}: {bound_count(store)}/{total} bound"
            )
            assert wait_until(lambda: m.gauge("scheduler_pending_binds") == 0.0, 5)
            pkg.assert_bind_invariants(store)
            out.append((opened, bound_count(store), _applied_once(store)))
        return out
    finally:
        sched.stop()
        pool.stop()


def test_soak_degrade_recover_cycles_no_loss_no_double_bind_like_reference():
    ref, port = both(_cycles)
    assert port == ref == [(True, 50 * (c + 1), True) for c in range(4)]


# -- (d) one deterministic adoption ------------------------------------------


def _parked_wave(pkg, server, pods, rec, noise_keys):
    """Stand `server`'s Scheduler by over the queued measured pods, stop its
    informers, then play the dead leader's last writes on the store: the
    binds of pods 0-7 landed (each on the node of an app=bench pod, as its
    zone affinity wants), pods 8-11 deleted, the rest parked unbound.
    Promote with no elector and wait for every parked pod to bind."""
    common = dict(
        device_batch_size=64, wave_m_cand=16, pipeline_depth=2, vector_preemption=False,
        antientropy_period_s=0, use_mesh=False, device_batch_window=0.0,
    )
    sched = pkg.scheduler(server, pkg.Config(**common))
    sched.start_standby(identity=f"det-{pkg.pkg}")
    try:
        for p in pods:
            server.create("pods", p)
        assert wait_until(lambda: len(sched.queue) == len(pods), 30)
        # the standby lags the dead leader's last writes from here on
        sched.informer_factory.stop()
        landed = [
            pkg.v1.Binding(
                pod_name=p.metadata.name, pod_namespace="default",
                pod_uid=server.get("pods", "default", p.metadata.name).metadata.uid,
                target_node=f"node-{(7 * i) % 64}",
            )
            for i, p in enumerate(pods[:8])
        ]
        assert server.bind_pods(landed) == [None] * 8
        for p in pods[8:12]:
            server.delete("pods", "default", p.metadata.name)
        if pkg.pkg == REF:
            r = _Recorder(sched, True, noise_keys)
        else:
            r = _Recorder(sched, False)

            def ref_noise(p, m_c):
                key = noise_keys.popleft()
                return torch.tensor(np.asarray(jax.random.uniform(key, (p, m_c), maxval=0.999)))

            sched._noise = ref_noise
        rec.append(r)
        a0 = _adoptions(pkg)
        sched.promote()
        adopted = _delta(_adoptions(pkg), a0)
        parked = [p.metadata.name for p in pods[12:]]
        assert wait_until(
            lambda: all(server.get("pods", "default", n).spec.node_name for n in parked), 60
        ), "the promoted standby never bound every parked pod"
        return adopted, {n: server.get("pods", "default", n).spec.node_name for n in parked}
    finally:
        sched.stop()


def test_adoption_of_a_parked_wave_places_like_reference():
    (ref_server, ref_pods), (server, pods), _n_init = _parity_servers("SchedulingPodAffinity")
    keys, recs = collections.deque(), []
    ref_adopted, ref_bound = _parked_wave(PKGS[REF], ref_server, ref_pods, recs, keys)
    port_adopted, port_bound = _parked_wave(PKGS[PORT], server, pods, recs, keys)
    assert ref_adopted == port_adopted == [8.0, len(pods) - 12, 4.0]
    ref_rec, port_rec = recs
    assert len(port_rec.results) == len(ref_rec.results) > 0
    assert [c[:2] for c in port_rec.commits] == [c[:2] for c in ref_rec.commits]
    if port_bound != ref_bound:
        ties = 0
        for r, p, eb in zip(ref_rec.results, port_rec.results, port_rec.ebs):
            ties += len(assert_tie_only(r, p, eb.pod_tpl_np))
        assert ties > 0, "the placements differ outside any near-tie"
    assert set(port_bound) == set(ref_bound)
    assert all(port_bound.values())
