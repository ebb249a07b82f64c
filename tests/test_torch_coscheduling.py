"""tests/test_coscheduling.py on the port: gang coscheduling (all-or-
nothing placement on QueueSort + Permit) through the port's Scheduler on
the CPU (device="cpu"), each scenario run through the reference's
Scheduler on the same inputs as well and the outcomes compared:

  * a full gang binds every member, in both;
  * a gang short of quorum binds nobody and, after the permit timeout,
    frees its reservations for a plain pod, in both;
  * a member that hard-fails rejects its parked siblings well before the
    permit timeout, in both;
  * the coscheduling QueueSort pops gang members adjacent: the same pop
    order in both;
  * a burst of 10 gangs x 20 binds every gang, in both.
"""

import importlib
import time

import pytest

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _reference_metrics_left_as_found():
    """This file runs the reference's Scheduler in the test process, and
    its counters are process-wide: a later reference test in the same
    process may read one absolutely (tests/test_preemptlattice.py reads
    scheduler_preemption_batches_total and _vector_hits_total without a
    reset). Put the reference's counters, gauges and histograms back as
    they were."""
    from kubernetes_tpu.utils.metrics import metrics as ref_metrics

    with ref_metrics._lock:
        saved = (dict(ref_metrics._counters), dict(ref_metrics._gauges), dict(ref_metrics._hists))
    yield
    with ref_metrics._lock:
        for live, before in zip(
            (ref_metrics._counters, ref_metrics._gauges, ref_metrics._hists), saved
        ):
            live.clear()
            live.update(before)


class _Pkg:
    """One package's objects, APIServer, Scheduler and coscheduling."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.v1 = importlib.import_module(f"{pkg}.api.objects")
        self.APIServer = importlib.import_module(f"{pkg}.client.apiserver").APIServer
        sched = importlib.import_module(f"{pkg}.scheduler")
        self.Scheduler, self.Config = sched.Scheduler, sched.KubeSchedulerConfiguration
        self.ProfileConfig = importlib.import_module(f"{pkg}.scheduler.config").ProfileConfig
        self.cos = importlib.import_module(f"{pkg}.scheduler.framework.plugins.coscheduling")
        self.plugin_set = importlib.import_module(
            f"{pkg}.scheduler.framework.registry").coscheduling_plugin_set
        self.queue = importlib.import_module(f"{pkg}.scheduler.queue.scheduling_queue")

    def node(self, name, cpu="4"):
        v1 = self.v1
        return v1.Node(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.NodeSpec(),
            status=v1.NodeStatus(allocatable={"cpu": cpu, "memory": "16Gi", "pods": 110}),
        )

    def gang_pod(self, name, gang, min_member, cpu="500m"):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(
                name=name,
                labels={self.cos.GROUP_LABEL: gang},
                annotations={self.cos.MIN_MEMBER_ANNOTATION: str(min_member)},
            ),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
        )

    def plain_pod(self, name, cpu):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
        )

    def gang_scheduler(self, server, permit_timeout=30.0):
        cfg = self.Config(
            profiles=[self.ProfileConfig(plugin_set=self.plugin_set())],
            coscheduling_permit_timeout=permit_timeout,
        )
        if self.pkg == "kubernetes_tpu_torch":
            return self.Scheduler(server, cfg, device="cpu")
        return self.Scheduler(server, cfg)


def _bound(server):
    pods, _ = server.list("pods")
    return sorted(p.metadata.name for p in pods if p.spec.node_name)


def _wait_bound(server, n, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(_bound(server)) >= n:
            return True
        time.sleep(0.05)
    return False


def _wait_pod_bound(server, name, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if server.get("pods", "default", name).spec.node_name:
            return True
        time.sleep(0.05)
    return False


def _all_or_nothing(p):
    server = p.APIServer()
    for i in range(8):
        server.create("nodes", p.node(f"n{i}"))
    sched = p.gang_scheduler(server)
    sched.start()
    try:
        for i in range(20):
            server.create("pods", p.gang_pod(f"g0-{i}", "g0", 20))
        assert _wait_bound(server, 20), f"{p.pkg}: full gang must bind"
        return _bound(server)
    finally:
        sched.stop()


def test_gang_binds_all_or_nothing_success():
    got = [_all_or_nothing(_Pkg(pkg)) for pkg in PKGS]
    assert got[0] == got[1] == sorted(f"g0-{i}" for i in range(20))


def _short_of_quorum(p):
    server = p.APIServer()
    server.create("nodes", p.node("n0", cpu="2"))
    sched = p.gang_scheduler(server, permit_timeout=1.0)
    sched.start()
    try:
        for i in range(8):
            server.create("pods", p.gang_pod(f"g1-{i}", "g1", 8))
        time.sleep(3.0)  # permit timeout + unreserve cascade
        partial = _bound(server)
        server.create("pods", p.plain_pod("solo", "2"))
        return partial, _wait_pod_bound(server, "solo")
    finally:
        sched.stop()


def test_gang_short_of_quorum_releases_resources():
    """Quorum 8, but only 4 x 500m fit the one 2-cpu node: no member
    binds, and after the permit timeout the freed node takes a plain pod
    of 2 cpu."""
    got = [_short_of_quorum(_Pkg(pkg)) for pkg in PKGS]
    assert got[0] == got[1] == ([], True), got


def _failed_member(p):
    server = p.APIServer()
    server.create("nodes", p.node("n0", cpu="4"))
    # long permit timeout: if release relied on it, the plain pod below
    # would not bind within the poll window
    sched = p.gang_scheduler(server, permit_timeout=120.0)
    sched.start()
    try:
        for i in range(3):
            server.create("pods", p.gang_pod(f"g2-{i}", "g2", 4, cpu="1"))
        server.create("pods", p.gang_pod("g2-big", "g2", 4, cpu="64"))
        server.create("pods", p.plain_pod("solo2", "4"))
        return _wait_pod_bound(server, "solo2"), [n for n in _bound(server) if n.startswith("g2")]
    finally:
        sched.stop()


def test_gang_failed_member_rejects_siblings_promptly():
    got = [_failed_member(_Pkg(pkg)) for pkg in PKGS]
    assert got[0] == got[1] == (True, []), got


def _pop_order(p):
    plugin = p.cos.Coscheduling()
    q = p.queue.PriorityQueue(less=plugin.less)
    for i in range(4):
        for g in ("gb", "ga"):
            q.add(p.gang_pod(f"{g}-{i}", g, 4))
    return [pi.pod.metadata.name for pi in q.pop_batch(8)]


def test_gang_members_pop_adjacent():
    ref, port = (_pop_order(_Pkg(pkg)) for pkg in PKGS)
    assert port == ref, (ref, port)
    gangs = [name.split("-")[0] for name in port]
    assert gangs == sorted(gangs), f"gangs interleaved in pop order: {port}"


def _burst(p):
    server = p.APIServer()
    for i in range(40):
        server.create("nodes", p.node(f"n{i}", cpu="8"))
    sched = p.gang_scheduler(server)
    sched.start()
    try:
        for g in range(10):
            for i in range(20):
                server.create("pods", p.gang_pod(f"g{g}-{i}", f"g{g}", 20))
        assert _wait_bound(server, 200, timeout=120), f"{p.pkg}: all gangs must bind"
        return _bound(server)
    finally:
        sched.stop()


def test_gang_burst_end_to_end():
    """10 gangs x 20 on 40 nodes of 8 cpu: every member of every gang
    binds, in both packages."""
    got = [_burst(_Pkg(pkg)) for pkg in PKGS]
    assert got[0] == got[1] and len(got[1]) == 200
