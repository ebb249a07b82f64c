"""Node loss through the port against the reference, on the CPU (the port's
Scheduler at device="cpu"): kubelets stop heartbeating, the node-lifecycle
controller taints their nodes and evicts their pods, replacements are
placed around the taints, and revived nodes are untainted.

Every case runs one scenario on both packages, each over its own store,
holds each run to the reference test's own assertions, and compares the
outcomes.

(a) The reference cases that drive the Scheduler or the heartbeat:
    tests/test_chaos_pipeline.py's eviction storm halted then drained,
    kubelet killed mid-bind, heartbeat retrying a transient 503 and
    heartbeat fast-dropping during an outage;
    tests/test_kubelet_and_wal.py's heartbeats feeding the eviction;
    tests/test_chaos.py's kubelet killed, evicted and rescheduled;
    tests/test_controllers.py's death detected and evicted. Compared:
    tainted nodes, evicted pods (by count where the placement is the
    package's own), the partial-disruption gauge, eviction and heartbeat
    counters, binds exactly once on the bind ledger (``ChaosStore``).
(b) One deterministic node-loss trace (``test_nodeloss_trace_matches_reference``):
    200 nodes in 4 zones, each with a kubelet (no pool thread: the test
    beats the live ones by hand) and a node lease; pods of ten
    ReplicaSet templates, the first tolerating every taint, the second
    the unreachable taint for TOLERATION_S seconds, the rest none. The
    lifecycle controller runs no thread: the test calls ``_monitor_once()``
    under a clock it sets (the ``time`` that each package's
    ``nodelifecycle`` and ``evictionbudget`` modules read, patched by the
    test) and creates the replacements itself. The trace: kill 20 of the
    nodes that hold a pod;
    a pass past the grace period; a pass past the eviction timeout; a
    replacement batch; revive 5 nodes; a pass past the toleration; a
    batch. Both Schedulers are driven batch by batch from the test thread,
    the port fed the reference's tie noise, as in
    tests/test_torch_soak.py. Compared exactly: the nodes tainted and the
    pods evicted at each pass, the deferred evictions, the partial-
    disruption gauge, the flushed ``taint_key``, ``taint_val``,
    ``taint_effect``, ``requested`` and ``valid``, and each batch's
    placements (chosen nodes equal but for a near-tie shown by
    ``assert_tie_only``). Wave and serial paths, two seeds.

Tolerances: exact counts, sets and columns; the reference tests' own
timeouts.
"""

import collections
import importlib
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.scheduler.config import KubeSchedulerConfiguration as RefConfig
from kubernetes_tpu_torch.perf.soak import host_snapshot
from kubernetes_tpu_torch.scheduler.config import KubeSchedulerConfiguration

from test_torch_ha import PKGS, PORT, REF, both, bound_count, wait_until
from test_torch_ha import _metrics_left_as_found  # noqa: F401
from test_torch_scheduler import _Recorder, _SerialRecorder, _settled, _wait
from test_torch_serial_lattice import reference_noise


class _NodeLoss:
    """One package's node-loss surface beside test_torch_ha's ``_Pkg``."""

    def __init__(self, pkg):
        imp = lambda m: importlib.import_module(f"{pkg}.{m}")
        self.pkg = PKGS[pkg]
        self.v1 = imp("api.objects")
        self.APIServer = imp("client.apiserver").APIServer
        self.Lease = imp("client.leaderelection").Lease
        kubelet = imp("kubelet.kubelet")
        self.NodeAgentPool, self.NODE_LEASE_NS = kubelet.NodeAgentPool, kubelet.NODE_LEASE_NS
        self.HollowCluster = imp("kubemark.hollow_node").HollowCluster
        self.lifecycle = imp("controller.nodelifecycle")
        self.budget = imp("controller.evictionbudget")
        self.ReplicaSetController = imp("controller.replicaset").ReplicaSetController
        self.DegradedWrites = imp("runtime.consensus").DegradedWrites
        self.workloads = imp("perf.workloads")

    def nlc(self, server, **kw):
        return self.lifecycle.NodeLifecycleController(server, **kw)

    def counter(self, name):
        return self.pkg.metrics.counter(name)

    def gauge(self, name):
        return self.pkg.metrics.gauge(name)

    def pod(self, name):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
        )

    def web_rs(self, replicas):
        """The reference cases' ReplicaSet "web"."""
        v1 = self.v1
        return v1.ReplicaSet(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.ReplicaSetSpec(
                replicas=replicas,
                selector={"app": "web"},
                template=v1.PodTemplateSpec(
                    metadata=v1.ObjectMeta(labels={"app": "web"}),
                    spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
                ),
            ),
        )

    def taint_keys(self, server, name):
        return {t.key for t in server.get("nodes", "", name).spec.taints}

    def tainted(self, server):
        return sorted(n.metadata.name for n in server.list("nodes")[0] if n.spec.taints)


NL = {p: _NodeLoss(p) for p in (REF, PORT)}


def both_nl(scenario, *args):
    """Run `scenario(nl, *args)` on the reference, then on the port."""
    return both(lambda pkg, *a: scenario(NL[pkg.pkg], *a), *args)


def _live_web(server, dead):
    """The app=web pods bound to a node other than `dead`, not deleting."""
    return [
        p for p in server.list("pods")[0]
        if p.metadata.labels.get("app") == "web"
        and p.metadata.deletion_timestamp is None
        and p.spec.node_name and p.spec.node_name != dead
    ]


# -- (a) the reference cases ----------------------------------------------------


def _storm_halts_then_drains(nl):
    """tests/test_chaos_pipeline.py::test_eviction_storm_halts_then_drains_rate_limited."""
    store = nl.pkg.ChaosStore()
    pool = nl.NodeAgentPool(store, heartbeat_interval=0.1, housekeeping_interval=0.1)
    names = [f"sn-{i}" for i in range(10)]
    for nm in names:
        pool.add_node(nm)
    nlc = nl.nlc(store, node_monitor_period=0.05, node_monitor_grace_period=0.5,
                 pod_eviction_timeout=0.4, eviction_limiter_qps=50.0)
    sched = nl.pkg.scheduler(store)
    pool.start()
    sched.start()
    nlc.start()
    try:
        for i in range(20):
            store.create("pods", nl.pod(f"victim-{i}"))
        assert wait_until(lambda: bound_count(store) == 20, 30)
        ev0 = nl.counter(nl.lifecycle.COUNTER_EVICTIONS)
        dead = names[:7]
        for nm in dead:
            pool.remove_node(nm)
        armed = wait_until(lambda: nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION) == 1.0, 10)
        assert armed, "mass unhealthiness never armed partial-disruption mode"
        time.sleep(1.0)  # well past grace + eviction timeout
        halted = nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0
        assert halted == 0, "evictions ran during the halted window"
        still_dead = set(dead[5:])
        doomed = {p.metadata.uid for p in store.list("pods")[0] if p.spec.node_name in still_dead}
        for nm in dead[:5]:
            pool.add_node(nm, register=False)
        assert wait_until(
            lambda: store.count("pods", lambda p: p.spec.node_name in still_dead) == 0, 20
        ), "pods on genuinely dead nodes were never evicted"
        evicted = nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0
        assert evicted > 0
        assert wait_until(lambda: all(
            not nd.spec.taints for nd in store.list("nodes")[0]
            if nd.metadata.name not in still_dead), 15)
        live = {p.metadata.uid for p in store.list("pods")[0]}
        nl.pkg.assert_bind_invariants(store, allow_deleted=True)
        return {
            "armed": armed, "evictions_in_halt": halted,
            # every pod of the two dead nodes, and only those, evicted
            "evicted_the_doomed": evicted == len(doomed) and not (doomed & live),
            "tainted_after": nl.tainted(store),
            "partial_after": nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION),
        }
    finally:
        nlc.stop()
        sched.stop()
        pool.stop()


@pytest.mark.slow
def test_eviction_storm_halts_then_drains_like_reference():
    ref, port = both_nl(_storm_halts_then_drains)
    assert port == ref == {
        "armed": True, "evictions_in_halt": 0.0,
        "evicted_the_doomed": True, "tainted_after": ["sn-5", "sn-6"],
        "partial_after": 0.0,
    }


def _kill_mid_bind(nl):
    """tests/test_chaos_pipeline.py::test_kill_kubelet_mid_bind_reschedules_everything."""
    store = nl.pkg.ChaosStore()
    pool = nl.NodeAgentPool(store, heartbeat_interval=0.1, housekeeping_interval=0.1)
    for i in range(4):
        pool.add_node(f"kn-{i}")
    nlc = nl.nlc(store, node_monitor_period=0.1, node_monitor_grace_period=0.8,
                 pod_eviction_timeout=0.3, eviction_limiter_qps=50.0)
    sched = nl.pkg.scheduler(store)
    rs = nl.ReplicaSetController(store)
    pool.start()
    sched.start()
    rs.start()
    nlc.start()
    try:
        ev0 = nl.counter(nl.lifecycle.COUNTER_EVICTIONS)
        store.create("replicasets", nl.web_rs(10))
        assert wait_until(lambda: bound_count(store) >= 3, 30)
        pool.remove_node("kn-0")
        assert wait_until(lambda: len(_live_web(store, "kn-0")) >= 10, 90), (
            "replicas never re-landed on surviving nodes")
        assert wait_until(lambda: store.count(
            "pods", lambda p: p.spec.node_name == "kn-0"
            and p.metadata.deletion_timestamp is None) == 0, 30)
        nl.pkg.assert_bind_invariants(store, allow_deleted=True)
        # the dead node's pods were evicted, each once; the replacements
        # avoid its taints
        evicted = nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0
        on_dead = {u for u, n in store.acked_binds.items() if n == "kn-0"}
        live = {p.metadata.uid for p in store.list("pods")[0]}
        return {
            "live_web": len(_live_web(store, "kn-0")),
            "evicted_every_kn0_pod": evicted == len(on_dead) and not (on_dead & live),
            "taints": sorted(nl.taint_keys(store, "kn-0")),
            "tainted": nl.tainted(store),
            "once": all(c == 1 for c in store.applied_binds.values()),
            "partial": nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION),
        }
    finally:
        nlc.stop()
        rs.stop()
        sched.stop()
        pool.stop()


def test_kill_kubelet_mid_bind_reschedules_everything_like_reference():
    ref, port = both_nl(_kill_mid_bind)
    assert port == ref == {
        "live_web": 10, "evicted_every_kn0_pod": True,
        "taints": ["node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable"],
        "tainted": ["kn-0"], "once": True, "partial": 0.0,
    }


def _heartbeat_retries_503(nl):
    """tests/test_chaos_pipeline.py::test_kubelet_heartbeat_retries_transient_503."""

    class FlakyLeaseStore(nl.APIServer):
        def __init__(self):
            super().__init__()
            self.fail_renewals = 0

        def guaranteed_update(self, kind, namespace, name, mutate):
            if kind == "leases" and self.fail_renewals > 0:
                self.fail_renewals -= 1
                raise nl.DegradedWrites("chaos: transient 503")
            return super().guaranteed_update(kind, namespace, name, mutate)

    store = FlakyLeaseStore()
    pool = nl.NodeAgentPool(store)
    kl = pool.add_node("hb-node")
    t = store.get("leases", nl.NODE_LEASE_NS, "hb-node").renew_time + 5.0
    store.fail_renewals = 2
    r0 = nl.counter("kubelet_heartbeat_retries_total")
    kl.heartbeat(now=t)
    renewed = store.get("leases", nl.NODE_LEASE_NS, "hb-node").renew_time == t
    assert renewed, "renewal dropped despite transient 503s"
    return {"renewed": renewed, "retries": nl.counter("kubelet_heartbeat_retries_total") - r0,
            "left": store.fail_renewals}


def test_kubelet_heartbeat_retries_transient_503_like_reference():
    ref, port = both_nl(_heartbeat_retries_503)
    assert port == ref == {"renewed": True, "retries": 2.0, "left": 0}


def _heartbeat_fast_drop(nl):
    """tests/test_chaos_pipeline.py::test_kubelet_heartbeat_fast_drops_during_persistent_outage."""
    store = nl.pkg.ChaosStore()
    pool = nl.NodeAgentPool(store)
    kl = pool.add_node("hb2-node")
    before = store.get("leases", nl.NODE_LEASE_NS, "hb2-node").renew_time
    store.degrade()
    d0 = nl.counter("kubelet_heartbeat_renewals_dropped_total")
    r0 = nl.counter("kubelet_heartbeat_retries_total")
    t0 = time.monotonic()
    kl.heartbeat(now=before + 5.0)
    fast = time.monotonic() - t0 < 0.2
    assert fast, "heartbeat stalled in retries"
    dropped = nl.counter("kubelet_heartbeat_renewals_dropped_total") - d0
    assert dropped > 0
    held = store.get("leases", nl.NODE_LEASE_NS, "hb2-node").renew_time == before
    assert held
    store.recover()
    kl.heartbeat(now=before + 6.0)
    renewed = store.get("leases", nl.NODE_LEASE_NS, "hb2-node").renew_time == before + 6.0
    assert renewed
    return {"fast": fast, "dropped": dropped, "held": held, "renewed": renewed,
            "retries": nl.counter("kubelet_heartbeat_retries_total") - r0}


def test_kubelet_heartbeat_fast_drops_during_outage_like_reference():
    ref, port = both_nl(_heartbeat_fast_drop)
    assert port == ref == {
        "fast": True, "dropped": 1.0, "held": True, "renewed": True, "retries": 0.0,
    }


def _heartbeats_feed_eviction(nl):
    """tests/test_kubelet_and_wal.py::test_kubelet_heartbeats_feed_nodelifecycle_eviction."""
    server = nl.APIServer()
    pool = nl.NodeAgentPool(server, heartbeat_interval=0.1, housekeeping_interval=0.1)
    pool.add_node("alive")
    pool.add_node("dying")
    sched = nl.pkg.scheduler(server)
    nlc = nl.nlc(server, node_monitor_period=0.1, node_monitor_grace_period=0.6,
                 pod_eviction_timeout=0.2)
    pool.start()
    sched.start()
    nlc.start()
    try:
        ev0 = nl.counter(nl.lifecycle.COUNTER_EVICTIONS)
        pod = nl.pod("victim")
        pod.spec.node_name = "dying"
        server.create("pods", pod)
        assert wait_until(
            lambda: server.get("pods", "default", "victim").status.phase == "Running", 20)
        pool.remove_node("dying")
        evicted = wait_until(
            lambda: not any(p.metadata.name == "victim" for p in server.list("pods")[0]), 30)
        assert evicted
        return {
            "evicted": evicted, "evictions": nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0,
            "taints": sorted(nl.taint_keys(server, "dying")), "tainted": nl.tainted(server),
            "partial": nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION),
        }
    finally:
        nlc.stop()
        sched.stop()
        pool.stop()


def test_kubelet_heartbeats_feed_nodelifecycle_eviction_like_reference():
    ref, port = both_nl(_heartbeats_feed_eviction)
    assert port == ref == {
        "evicted": True, "evictions": 1.0,
        "taints": ["node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable"],
        "tainted": ["dying"], "partial": 0.0,
    }


def _kill_evict_reschedule(nl):
    """tests/test_chaos.py::test_kill_kubelet_node_evicts_and_reschedules."""
    server = nl.APIServer()
    cluster = nl.HollowCluster(server, num_nodes=3, heartbeat_interval=0.2)
    sched = nl.pkg.scheduler(server)
    rs = nl.ReplicaSetController(server)
    nlc = nl.nlc(server, node_monitor_period=0.2, node_monitor_grace_period=1.0,
                 pod_eviction_timeout=0.5)
    cluster.start()
    sched.start()
    rs.start()
    nlc.start()
    try:
        ev0 = nl.counter(nl.lifecycle.COUNTER_EVICTIONS)
        server.create("replicasets", nl.web_rs(6))
        assert wait_until(lambda: server.count(
            "pods", lambda p: bool(p.spec.node_name)
            and p.metadata.labels.get("app") == "web") == 6, 60)
        on_dead = {p.metadata.uid for p in server.list("pods")[0]
                   if p.spec.node_name == "hollow-node-0"}
        cluster.kill_node("hollow-node-0")
        healthy = wait_until(lambda: len(_live_web(server, "hollow-node-0")) >= 6, 90)
        assert healthy, "replicas must re-land on surviving nodes after node death"
        # the dead node's pods: each evicted (the replacements were created
        # for them), none left running there
        assert wait_until(lambda: nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0
                          >= len(on_dead), 30)
        # the dead node is tainted whether or not it held a replica
        assert wait_until(
            lambda: nl.lifecycle.TAINT_UNREACHABLE in nl.taint_keys(server, "hollow-node-0"), 15)
        live = {p.metadata.uid for p in server.list("pods")[0]}
        return {
            "healthy": healthy,
            "evicted_every_dead_pod": (nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0
                                       == len(on_dead)) and not (on_dead & live),
            "live_web": len(_live_web(server, "hollow-node-0")),
            "tainted": nl.tainted(server),
            "partial": nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION),
        }
    finally:
        nlc.stop()
        rs.stop()
        sched.stop()
        cluster.stop()


def test_kill_kubelet_node_evicts_and_reschedules_like_reference():
    ref, port = both_nl(_kill_evict_reschedule)
    assert port == ref == {
        "healthy": True, "evicted_every_dead_pod": True, "live_web": 6,
        "tainted": ["hollow-node-0"], "partial": 0.0,
    }


def _detects_death_and_evicts(nl):
    """tests/test_controllers.py::test_nodelifecycle_detects_death_and_evicts."""
    server = nl.APIServer()
    hollow = nl.HollowCluster(server, num_nodes=2, heartbeat_interval=0.2)
    sched = nl.pkg.scheduler(server)
    nlc = nl.nlc(server, node_monitor_period=0.2, node_monitor_grace_period=1.0,
                 pod_eviction_timeout=1.5)
    hollow.start()
    sched.start()
    nlc.start()
    try:
        ev0 = nl.counter(nl.lifecycle.COUNTER_EVICTIONS)
        server.create("pods", nl.pod("victim"))
        assert wait_until(lambda: server.get("pods", "default", "victim").spec.node_name, 60)
        node_name = server.get("pods", "default", "victim").spec.node_name
        hollow.kill_node(node_name)
        tainted = wait_until(
            lambda: nl.lifecycle.TAINT_UNREACHABLE in nl.taint_keys(server, node_name), 15)
        assert tainted
        evicted = wait_until(
            lambda: not any(p.metadata.name == "victim" for p in server.list("pods")[0]), 15)
        assert evicted
        other = next(n.metadata.name for n in server.list("nodes")[0]
                     if n.metadata.name != node_name)
        assert not server.get("nodes", "", other).spec.taints
        return {
            "tainted": tainted, "evicted": evicted,
            "evictions": nl.counter(nl.lifecycle.COUNTER_EVICTIONS) - ev0,
            "taints": sorted(nl.taint_keys(server, node_name)),
            "tainted_nodes": len(nl.tainted(server)),
            "partial": nl.gauge(nl.lifecycle.GAUGE_PARTIAL_DISRUPTION),
        }
    finally:
        nlc.stop()
        sched.stop()
        hollow.stop()


def test_nodelifecycle_detects_death_and_evicts_like_reference():
    ref, port = both_nl(_detects_death_and_evicts)
    assert port == ref == {
        "tainted": True, "evicted": True, "evictions": 1.0,
        "taints": ["node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable"],
        "tainted_nodes": 1, "partial": 0.0,
    }


# -- (b) the deterministic node-loss trace ---------------------------------------

from test_torch_soak import _drive_serial, _drive_wave, _Side  # noqa: E402

TRACE_NODES, TRACE_ZONES = 200, 4
N_KILL, N_REVIVE = 20, 5
N_RS, PER_RS = 10, 4  # ReplicaSet templates; pods of each at the start
GRACE_S, EVICTION_TIMEOUT_S, TOLERATION_S = 4.0, 1.0, 3
# the eviction limiter: a burst below the dead nodes with victims, so the
# passes also defer (on the test's clock, so both packages refill alike)
LIMITER = dict(eviction_limiter_qps=4.0, eviction_limiter_burst=12)
TRACE_BATCH = 16
FLUSHED = ("taint_key", "taint_val", "taint_effect", "requested", "valid")
UNREACHABLE_BACKOFF_S = 1e6
T0 = 1_000_000.0  # the test clock at the start


class _Clock:
    """The clock the lifecycle controller and its eviction limiter read:
    ``time.time()`` and ``time.monotonic()`` both give ``now``."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def monotonic(self):
        return self.now


def _rs_pod(nl, k, name):
    """A pod of ReplicaSet template k (SchedulingBasic's requests): rs0
    tolerates every taint (the DaemonSet form), rs1 the unreachable taint
    for TOLERATION_S seconds, the rest nothing."""
    v1 = nl.v1
    tol = {
        0: [v1.Toleration(key="", operator=v1.TOLERATION_OP_EXISTS)],
        1: [v1.Toleration(key=nl.lifecycle.TAINT_UNREACHABLE, operator=v1.TOLERATION_OP_EXISTS,
                          effect=v1.TAINT_NO_EXECUTE, toleration_seconds=TOLERATION_S)],
    }.get(k, [])
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels={"rs": f"rs{k}"}),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": "100m", "memory": "128Mi"})],
            tolerations=tol,
        ),
    )


class _TraceSide(_Side):
    """One package's store, kubelets, lifecycle controller and Scheduler
    under the trace."""

    def __init__(self, pkg, sched_kw):
        nl = NL[pkg]
        super().__init__(pkg, nl.APIServer(), None)
        self.nl = nl
        for i in range(TRACE_NODES):
            name = f"node-{i}"
            self.server.create("nodes", nl.workloads.make_bench_node(name, f"zone-{i % TRACE_ZONES}"))
            self.server.create("leases", nl.Lease(
                metadata=self.v1.ObjectMeta(name=name, namespace=nl.NODE_LEASE_NS),
                holder_identity=name, lease_duration_seconds=40.0, renew_time=T0))
        self.pool = nl.NodeAgentPool(self.server, heartbeat_interval=1.0)
        for i in range(TRACE_NODES):
            self.pool.add_node(f"node-{i}", register=False)
        self.nlc = nl.nlc(self.server, node_monitor_grace_period=GRACE_S,
                          pod_eviction_timeout=EVICTION_TIMEOUT_S, **LIMITER)
        cfg = (RefConfig if pkg == REF else KubeSchedulerConfiguration)(**sched_kw["common"])
        kw = {} if pkg == REF else dict(device="cpu", **sched_kw["noise"])
        self.sched = nl.pkg._Scheduler(self.server, cfg, **kw)

    def beat(self, now):
        """One pass of the pool's heartbeat loop at `now`."""
        for kl in list(self.pool.kubelets.values()):
            kl.heartbeat(now)

    def pods(self):
        return {p.metadata.name: p.spec.node_name for p in self.server.list("pods")[0]}

    def taints(self):
        return {n.metadata.name: sorted((t.key, t.effect) for t in n.spec.taints)
                for n in self.server.list("nodes")[0] if n.spec.taints}

    def monitor(self, now):
        """The live kubelets beat, then one lifecycle pass; returns what the
        pass changed and its counters."""
        lc = self.nl.lifecycle
        self.beat(now)
        before = self.pods()
        ev0, de0 = (self.nl.counter(c) for c in (lc.COUNTER_EVICTIONS, lc.COUNTER_EVICTIONS_DEFERRED))
        self.nlc._monitor_once()
        after = self.pods()
        return {
            "evicted": sorted(set(before) - set(after)),
            "evictions": self.nl.counter(lc.COUNTER_EVICTIONS) - ev0,
            "deferred": self.nl.counter(lc.COUNTER_EVICTIONS_DEFERRED) - de0,
            "partial": self.nl.gauge(lc.GAUGE_PARTIAL_DISRUPTION),
            "unhealthy": self.nl.gauge(lc.GAUGE_UNHEALTHY_FRACTION),
            "taints": self.taints(),
        }

    def create(self, pods):
        for k, name in pods:
            self.server.create("pods", _rs_pod(self.nl, k, name))


def _untolerated(sides, names):
    """The pods of `names` that sit on a node with a NoSchedule or
    NoExecute taint they do not tolerate (from the API server)."""
    out = []
    for side in sides:
        v1 = side.v1
        taints = {n.metadata.name: n.spec.taints for n in side.server.list("nodes")[0]}
        for p in side.server.list("pods")[0]:
            if p.metadata.name in names and p.spec.node_name and v1.find_untolerated_taint(
                    taints[p.spec.node_name], p.spec.tolerations) is not None:
                out.append((side.pkg, p.metadata.name, p.spec.node_name))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_wave", [True, False], ids=["wave", "serial"])
def test_nodeloss_trace_matches_reference(monkeypatch, use_wave, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock(T0)
    for nl in NL.values():
        monkeypatch.setattr(nl.lifecycle, "time", clock)
        monkeypatch.setattr(nl.budget, "time", clock)
    common = dict(
        device_batch_size=TRACE_BATCH, antientropy_period_s=0, use_mesh=False,
        device_batch_window=0.0, pod_initial_backoff_seconds=UNREACHABLE_BACKOFF_S,
        pod_max_backoff_seconds=UNREACHABLE_BACKOFF_S,
    )
    keys = collections.deque()
    if use_wave:
        common.update(wave_m_cand=TRACE_BATCH, pipeline_depth=2, vector_preemption=False)

        def wave_noise(p, m_c):
            return torch.tensor(np.asarray(jax.random.uniform(keys.popleft(), (p, m_c), maxval=0.999)))

        noise = dict(noise=wave_noise)
    else:
        common.update(use_wave=False)

        def serial_noise(p, n):
            key, rp, rn = keys.popleft()
            assert (rp, rn) == (p, n)
            return torch.tensor(reference_noise(key, p, n))

        noise = dict(serial_noise=serial_noise)
    sides = [_TraceSide(p, {"common": common, "noise": noise}) for p in (REF, PORT)]
    ref, port = (s.sched for s in sides)
    rec = _Recorder if use_wave else _SerialRecorder
    ref_rec, port_rec = rec(ref, True, keys), rec(port, False)
    drive = _drive_wave if use_wave else _drive_serial
    step = ""

    def caught_up():
        for side in sides:
            side.caught_up()

    def same_flushed():
        caught_up()
        ref_dev, ref_rows, ref_bad = sides[0].flushed(jax.device_get)
        port_dev, port_rows, port_bad = sides[1].flushed(host_snapshot)
        assert port_rows == ref_rows, step
        assert ref_bad == [] and port_bad == [], (step, ref_bad, port_bad)
        for f in FLUSHED:
            a, b = np.asarray(getattr(ref_dev, f)), getattr(port_dev, f).numpy()
            assert a.dtype == b.dtype, (step, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f"seed {seed}, {step}: {f}")
        return port_dev

    class Diverged(Exception):
        """A near-tie placed a pod on another node on each side (shown by
        assert_tie_only): the clusters differ from here on, so the trace
        stops, as tests/test_torch_soak.py's does."""

    def schedule(pods):
        """Create `pods` on both sides and drive both Schedulers to idle;
        the placements must agree, or differ only inside near-ties."""
        for side in sides:
            side.create(pods)
        caught_up()
        for side in sides:
            side.activate_queued()
        ties = drive(ref, port, ref_rec, port_rec)
        for s in (ref, port):
            _wait(lambda s=s: _settled(s), 30, "the informers to confirm every bind")
            s._drain_trailing(block=True)
        placed = [side.pods() for side in sides]
        assert not _untolerated(sides, {name for _k, name in pods}), step
        if ties:
            assert {p for p, n in placed[1].items() if n} == {p for p, n in placed[0].items() if n}
            raise Diverged(step)
        assert placed[1] == placed[0], step
        assert sides[1].queued() == sides[0].queued() == set(), step
        same_flushed()
        return placed[0]

    try:
        for s in (ref, port):
            s._bringup()
        step = "the initial pods"
        initial = [(k, f"rs{k}-{i}") for i in range(PER_RS) for k in range(N_RS)]
        placed = schedule(initial)
        assert all(placed.values())
        # the kill takes 20 of the nodes that hold a pod (a node with none
        # has nothing to evict)
        holding = sorted(set(placed.values()), key=lambda n: int(n.split("-")[1]))
        killed = [holding[i] for i in rng.choice(len(holding), N_KILL, replace=False)]
        revived = killed[:N_REVIVE]
        on_killed = {p for p, n in placed.items() if n in killed}

        # 1. kill: the kubelets stop, their leases age from T0
        for side in sides:
            for name in killed:
                side.pool.remove_node(name)
        # 2. a pass past the grace period: both taints on every killed node
        step = "the pass past the grace period"
        clock.now = t_taint = T0 + GRACE_S + 0.5
        p1 = [side.monitor(clock.now) for side in sides]
        assert p1[1] == p1[0], step
        lc = NL[REF].lifecycle
        both_taints = sorted([(lc.TAINT_UNREACHABLE, "NoExecute"), (lc.TAINT_NOT_READY, "NoSchedule")])
        assert p1[0]["taints"] == {n: both_taints for n in killed}, step
        assert p1[0]["evicted"] == [] and p1[0]["partial"] == 0.0, step
        assert p1[0]["unhealthy"] == N_KILL / TRACE_NODES, step
        dev = same_flushed()
        rows = [sides[1].sched.cache.encoder.row_of(n) for n in killed]
        assert (dev.taint_key[rows, :2] >= 0).all(), step

        # 3. a pass past the eviction timeout, inside rs1's toleration:
        # rs2-9's pods on the dead nodes go, up to the limiter's burst
        step = "the pass past the eviction timeout"
        clock.now = t_taint + EVICTION_TIMEOUT_S + 0.5
        p2 = [side.monitor(clock.now) for side in sides]
        assert p2[1] == p2[0], step
        ev1 = p2[0]["evicted"]
        assert set(ev1) <= on_killed and ev1, step
        assert not any(n.startswith(("rs0-", "rs1-")) for n in ev1), step
        assert p2[0]["evictions"] == len(ev1) and p2[0]["partial"] == 0.0, step
        same_flushed()

        # 4. a replacement batch around the taints
        step = "the first replacement batch"
        repl = [(int(n[2]), f"{n.split('-')[0]}-r{j}") for j, n in enumerate(ev1)]
        schedule(repl)

        # 5. revive: the kubelets restart, their leases renew at the next beat
        for side in sides:
            for name in revived:
                side.pool.add_node(name, register=False)
        # 6. a pass past rs1's toleration: the revived are untainted, the
        # still-dead drain (rs1's pods too) as far as the limiter allows
        step = "the pass after the revival"
        clock.now = t_taint + TOLERATION_S + 1.0
        p3 = [side.monitor(clock.now) for side in sides]
        assert p3[1] == p3[0], step
        assert set(p3[0]["taints"]) == set(killed) - set(revived), step
        ev2 = p3[0]["evicted"]
        assert set(ev2) <= on_killed - set(ev1), step
        assert not any(n.startswith("rs0-") for n in ev2), step
        assert p3[0]["evictions"] == len(ev2), step
        dev = same_flushed()
        rows = [sides[1].sched.cache.encoder.row_of(n) for n in revived]
        assert (dev.taint_key[rows] == -1).all(), step

        # 7. a batch: the second round of replacements and a pod more of
        # each of rs2-9, which the revived nodes may take
        step = "the second batch"
        repl2 = [(int(n[2]), f"{n.split('-')[0]}-s{j}") for j, n in enumerate(ev2)]
        extra = [(2 + j, f"rs{2 + j}-x{j}") for j in range(N_RS - 2)]
        schedule(repl2 + extra)
        deferred = p2[0]["deferred"] + p3[0]["deferred"]
        assert ev1 or ev2 or deferred, "the trace evicted nothing"
    except Diverged:
        pass
    finally:
        for s in (ref, port):
            s.stop()
