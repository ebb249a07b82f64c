"""tests/test_tracing.py on the port: per-pod scheduling traces, tail
exemplars, reservoir-sampled histograms, the debug listeners and the
trace header on the REST /binding hop. Every case runs the same inputs
through the reference's modules and the port's (its copy of
utils/tracing.py and utils/metrics.py, the port's Scheduler with
device="cpu", its harness) and requires the same outcome:

  * the reservoir and tracer units (the same seeded reservoir, the same
    quantiles, exemplars, ring and overflow behaviour);
  * a bound pod's span chain and store stamp, and the preemptor's
    preempt.select -> delete -> nominate chain;
  * the p99 exemplar resolving to a finished trace that reconciles with
    the e2e histogram, the SIGUSR2 dump and /debug/traces;
  * X-Trace-Context on a REST bind and on a fenced zombie bind, the REST
    /metrics endpoint;
  * monotonic spans;
  * run_latency_benchmark's waterfall on SchedulingBasic/500 against e2e.

Each package's tracer is reset around every case, as the reference's
suite does; the reference's process-wide tracer and metrics are put back
as this file found them (a later reference test in the same process may
read them)."""

import importlib
import inspect
import json
import time
import urllib.request
from contextlib import contextmanager

import pytest

from test_torch_coscheduling import _reference_metrics_left_as_found  # noqa: F401

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


class _Pkg:
    def __init__(self, pkg):
        self.pkg = pkg
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.v1 = mod("api.objects")
        apiserver = mod("client.apiserver")
        self.APIServer, self.LeaderFenced = apiserver.APIServer, apiserver.LeaderFenced
        self.BindFence = mod("client.leaderelection").BindFence
        sched = mod("scheduler")
        self.Scheduler, self.Config = sched.Scheduler, sched.KubeSchedulerConfiguration
        self.CacheDebugger = mod("scheduler.cache.debugger").CacheDebugger
        self.serve_debug = mod("utils.debugserver").serve_debug
        m = mod("utils.metrics")
        self.Histogram, self.metrics = m.Histogram, m.metrics
        self.tracing = mod("utils.tracing")
        self.tracer = self.tracing.tracer
        self.serve = mod("apiserver.rest").serve
        self.RESTClient = mod("apiserver.client").RESTClient
        self.harness = mod("perf.harness")
        self.WORKLOADS = mod("perf.workloads").WORKLOADS

    def scheduler(self, server, cfg):
        if self.pkg == "kubernetes_tpu_torch":
            return self.Scheduler(server, cfg, device="cpu")
        return self.Scheduler(server, cfg)

    def node(self, name, cpu="32"):
        v1 = self.v1
        return v1.Node(
            metadata=v1.ObjectMeta(name=name, namespace=""),
            spec=v1.NodeSpec(),
            status=v1.NodeStatus(allocatable={"cpu": cpu, "memory": "64Gi", "pods": 110}),
        )

    def pod(self, name):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name, namespace="default"),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
        )


P = {pkg: _Pkg(pkg) for pkg in PKGS}


def _both(scenario):
    """scenario(pkg) for the reference, then the port: equal outcomes."""
    ref, port = (scenario(P[pkg]) for pkg in PKGS)
    assert port == ref, (ref, port)
    return port


@pytest.fixture(autouse=True, scope="module")
def _reference_tracer_left_as_found():
    t = P["kubernetes_tpu"].tracer
    with t._lock:
        saved = (dict(t._active), dict(t._by_key), list(t._ring),
                 list(t._store_ledger), dict(t._counts))
    yield
    with t._lock:
        t._active.clear()
        t._active.update(saved[0])
        t._by_key.clear()
        t._by_key.update(saved[1])
        t._ring.clear()
        t._ring.extend(saved[2])
        t._store_ledger.clear()
        t._store_ledger.extend(saved[3])
        t._counts.clear()
        t._counts.update(saved[4])


@pytest.fixture(autouse=True)
def _fresh_tracers():
    for p in P.values():
        p.tracer.reset()
    yield
    for p in P.values():
        p.tracer.reset()


def wait_until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# -- reservoir sampling --------------------------------------------------------


def test_reservoir_late_outliers_shift_p99():
    """Late outliers must move the reported p99 (true reservoir
    sampling), and the reservoir is seeded: both packages keep the same
    samples."""

    def scenario(p):
        h = p.Histogram(max_samples=200)
        for _ in range(2000):
            h.observe(0.01)
        frozen = h.quantile(0.99)
        for _ in range(2000):
            h.observe(0.1)
        return frozen, h.quantile(0.99), list(h._samples)

    frozen, late, _samples = _both(scenario)
    assert frozen == pytest.approx(0.01)
    assert late == pytest.approx(0.1)


def test_reservoir_quantiles_since_windows_out_warmup():
    def scenario(p):
        h = p.Histogram(max_samples=1000)
        for _ in range(500):
            h.observe(5.0)  # compile-laden warmup
        n0 = h.n
        for _ in range(500):
            h.observe(0.002)
        return h.quantiles_since(n0, (0.99,))[0], h.quantile(0.2)

    since, q20 = _both(scenario)
    assert since == pytest.approx(0.002)
    assert q20 in (pytest.approx(0.002), pytest.approx(5.0))


def test_histogram_exemplars_track_the_tail():
    def scenario(p):
        h = p.Histogram()
        for i in range(100):
            h.observe(0.001 * (i + 1), exemplar=f"t{i}")
        p.metrics.observe("tracing_test_series_seconds", 1.5, exemplar="deadbeef")
        line = '# exemplar tracing_test_series_seconds 1.5 trace_id="deadbeef"'
        return h.exemplars()[0], h.exemplar_near(0.99), line in p.metrics.render_prometheus()

    top, near, rendered = _both(scenario)
    assert top == (pytest.approx(0.1), "t99")
    assert near is not None and near[1] in {f"t{i}" for i in range(90, 100)}
    assert rendered


# -- tracer units --------------------------------------------------------------


def test_tracer_span_chain_and_ring():
    def scenario(p):
        t = p.tracing.Tracer(ring_size=4)
        tid = t.start("pod", "default/x")
        t0 = time.monotonic()
        t.add_span(tid, "queue", t0 - 0.05, t0)
        with t.span(tid, "bind"):
            time.sleep(0.002)
        t.event(tid, "unschedulable", "0/5 nodes")
        t.finish(tid, outcome="bound", node="n-1")
        got = t.get(tid)
        queue_ms = got["stages_ms"]["queue"]
        for i in range(10):
            t.finish(t.start("pod", f"default/y{i}"))
        return (got["finished"], got["outcome"], sorted(got["stages_ms"]),
                got["events"][0]["name"], queue_ms == pytest.approx(50, rel=0.2),
                t.get(tid) is None, len(t.slowest(100)))

    got = _both(scenario)
    assert got == (True, "bound", ["bind", "queue"], "unschedulable", True, True, 4)


def test_tracer_span_closes_on_exception():
    def scenario(p):
        t = p.tracing.Tracer()
        tid = t.start("pod", "default/exc")
        with pytest.raises(RuntimeError):
            with t.span(tid, "bind"):
                raise RuntimeError("boom")
        t.finish(tid)
        return sorted(t.get(tid)["stages_ms"])

    assert _both(scenario) == ["bind"]


def test_tracer_disabled_is_inert():
    def scenario(p):
        t = p.tracing.Tracer()
        t.set_enabled(False)
        try:
            tid = t.start("pod", "default/z")
            t.add_span("", "queue", 0.0, 1.0)
            t.finish("")
            return tid, t.slowest(5), t.trace_for_pod("default/z")
        finally:
            t.set_enabled(True)

    assert _both(scenario) == ("", [], "")


def test_tracer_active_overflow_evicts_oldest():
    def scenario(p):
        t = p.tracing.Tracer(max_active=3)
        tids = [t.start("pod", f"default/a{i}") for i in range(5)]
        return [t.get(tid) is not None for tid in tids]

    assert _both(scenario) == [False, False, True, True, True]


def test_bind_context_overrides_active_index():
    def scenario(p):
        t0 = p.tracer.start("pod", "default/ctx")
        with p.tracing.bind_context({"default/ctx": "feedface"}):
            inside = p.tracer.trace_for_pod("default/ctx")
        return inside, p.tracer.trace_for_pod("default/ctx") == t0

    assert _both(scenario) == ("feedface", True)


# -- in-process end to end: Scheduler -> store, host path -----------------------


@contextmanager
def bound_cluster(p):
    """6 nodes, 8 pods bound by a Scheduler on the host path
    (use_device=False), the package's metrics reset first."""
    p.metrics.reset()
    server = p.APIServer()
    sched = p.scheduler(server, p.Config(use_device=False))
    for i in range(6):
        server.create("nodes", p.node(f"tr-{i}"))
    sched.start()
    try:
        for i in range(8):
            server.create("pods", p.pod(f"tp-{i}"))

        def bound():
            pods, _ = server.list("pods")
            return sum(1 for x in pods if x.spec.node_name)

        assert wait_until(lambda: bound() >= 8, 30)
        yield server, sched
    finally:
        sched.stop()


def test_pod_trace_complete_and_store_stamped():
    def scenario(p):
        with bound_cluster(p):
            slow = p.tracer.slowest(20)
            d = next(t for t in slow if t["key"].startswith("default/tp-"))
            full = p.tracer.get(d["trace_id"])
            pods = sorted(t["key"] for t in slow if t["key"].startswith("default/tp-"))
            return (pods, d["outcome"], sorted(d["stages_ms"]),
                    sorted({s["event"] for s in full.get("store_stamps", [])}),
                    full["attrs"].get("node", "").startswith("tr-"))

    pods, outcome, stages, stamps, on_node = _both(scenario)
    assert len(pods) == 8 and outcome == "bound" and on_node
    assert {"queue", "algo", "bind"} <= set(stages)
    assert "applied" in stamps


def test_preempt_span_chain_on_preemptor_trace():
    """The preempt.select -> preempt.delete -> preempt.nominate chain lands
    on the preemptor pod's own trace, in both."""

    def scenario(p):
        p.metrics.reset()
        server = p.APIServer()
        sched = p.scheduler(server, p.Config(use_device=False))
        server.create("nodes", p.node("pr-0", cpu="2"))
        sched.start()
        try:
            victim = p.pod("victim")
            victim.spec.priority = 0
            victim.spec.containers[0].requests = {"cpu": "2"}
            server.create("pods", victim)
            assert wait_until(lambda: server.get("pods", "default", "victim").spec.node_name, 30)
            hi = p.pod("preemptor")
            hi.spec.priority = 100
            hi.spec.containers[0].requests = {"cpu": "2"}
            server.create("pods", hi)
            assert wait_until(
                lambda: server.get("pods", "default", "preemptor").status.nominated_node_name
                == "pr-0", 30)
            tid = p.tracer.trace_for_pod("default/preemptor")
            full = p.tracer.get(tid) if tid else None
        finally:
            sched.stop()
        assert full is not None, p.pkg
        chain = [s["name"] for s in full["spans"] if s["name"].startswith("preempt.")]
        delete = next(s for s in full["spans"] if s["name"] == "preempt.delete")
        return chain, delete["attrs"].get("victims")

    chain, victims = _both(scenario)
    assert {"preempt.select", "preempt.delete", "preempt.nominate"} <= set(chain)
    assert victims == 1


_IN_CYCLE = ("algo", "assume", "bind", "encode", "device", "readback", "guard")


def test_p99_exemplar_resolves_to_full_trace():
    def scenario(p):
        with bound_cluster(p):
            h = p.metrics.histogram("e2e_scheduling_duration_seconds")
            val, tid = h.exemplar_near(0.99)
            d = p.tracer.get(tid)
            cycle = sum(v for k, v in d["stages_ms"].items() if k in _IN_CYCLE)
            return h.n >= 8, d["finished"], cycle / 1e3 == pytest.approx(val, rel=0.05)

    assert _both(scenario) == (True, True, True)


def test_sigusr2_dump_has_traces_section():
    def scenario(p):
        with bound_cluster(p) as (_server, sched):
            dump = p.CacheDebugger(sched).dump()
        return tuple(s in dump for s in (
            "Dump of per-pod scheduling traces (slowest first):", "total=",
            "Dump of tracing pipeline state:", "tracing_traces_completed_total"))

    assert _both(scenario) == (True, True, True, True)


def test_debug_listener_serves_metrics_and_traces():
    def scenario(p):
        with bound_cluster(p):
            srv = p.serve_debug(0)
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
                    body = r.read().decode()
                with urllib.request.urlopen(f"{base}/debug/traces?n=5", timeout=5) as r:
                    payload = json.loads(r.read())
                tid = payload["slowest"][0]["trace_id"]
                with urllib.request.urlopen(f"{base}/debug/traces?id={tid}", timeout=5) as r:
                    one = json.loads(r.read())
            finally:
                srv.shutdown()
                srv.server_close()
        return ("e2e_scheduling_duration_seconds" in body, "tracing_traces_total" in body,
                len(payload["slowest"]), bool(payload["stages"]), one["trace_id"] == tid,
                bool(one["spans"]))

    assert _both(scenario) == (True, True, 5, True, True, True)


# -- the bench stage waterfall (the wave path) ----------------------------------


def test_latency_bench_waterfall_reconciles_with_e2e():
    """The steady-state bench's waterfall from real spans: every in-cycle
    stage attributed, the in-cycle stage sums within 5% of
    e2e_scheduling_duration_seconds, and the p99 exemplar resolving to a
    finished trace; the port on its wave path on the CPU."""

    def scenario(p):
        kw = {"device": "cpu"} if p.pkg == "kubernetes_tpu_torch" else {}
        lat = p.harness.run_latency_benchmark(
            p.WORKLOADS["SchedulingBasic/500"], rate_pods_per_s=120.0, n_pods=60, **kw)
        wf = lat.stage_waterfall
        stages = ("queue", "encode", "device", "readback", "guard", "assume", "bind")
        return (lat.scheduled, {s: s in wf and wf[s]["count"] >= 50 for s in stages},
                0.95 <= lat.waterfall_vs_e2e <= 1.05, bool(lat.p99_trace_id),
                lat.p99_trace is not None and lat.p99_trace["finished"],
                p.tracer.get(lat.p99_trace_id) is not None)

    scheduled, stages, reconciled, *exemplar = _both(scenario)
    assert scheduled == 60 and all(stages.values()), stages
    assert reconciled and exemplar == [True, True, True]


# -- the REST hop: X-Trace-Context survives the wire ----------------------------


@contextmanager
def rest_stack(p):
    srv, port, store = p.serve(store=p.APIServer(), port=0)
    try:
        yield port, store, p.RESTClient(f"http://127.0.0.1:{port}", timeout=5.0)
    finally:
        srv.shutdown()
        srv.server_close()


def test_trace_header_survives_rest_bind():
    def scenario(p):
        with rest_stack(p) as (port, store, client):
            store.create("nodes", p.node("rest-0"))
            store.create("pods", p.pod("rp-0"))
            # an id the server's own active index cannot know: only the
            # X-Trace-Context header delivers it
            with p.tracing.bind_context({"default/rp-0": "feedbeefcafe0001"}):
                errs = client.bind_pods([p.v1.Binding(
                    pod_name="rp-0", pod_namespace="default", target_node="rest-0")])
            stamps = [(s["event"], s.get("node")) for s in p.tracer.stamps_for("feedbeefcafe0001")]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/traces?id=feedbeefcafe0001", timeout=5) as r:
                served = json.loads(r.read())["store_stamps"][0]["event"]
        return errs, stamps, served

    errs, stamps, served = _both(scenario)
    assert errs == [None] and ("applied", "rest-0") in stamps and served == "applied"


def test_trace_header_stamps_fenced_zombie_bind():
    def scenario(p):
        with rest_stack(p) as (_port, store, client):
            store.create("nodes", p.node("rest-1"))
            store.create("pods", p.pod("rp-1"))
            stale = p.BindFence(namespace="kube-system", name="kube-scheduler",
                                identity="zombie-a", transitions=41)
            with p.tracing.bind_context({"default/rp-1": "feedbeefcafe0002"}):
                with pytest.raises(p.LeaderFenced):
                    client.bind_pods([p.v1.Binding(
                        pod_name="rp-1", pod_namespace="default", target_node="rest-1")],
                        fence=stale)
            stamps = [(s["event"], s.get("identity"))
                      for s in p.tracer.stamps_for("feedbeefcafe0002")]
            return stamps, store.get("pods", "default", "rp-1").spec.node_name

    stamps, node = _both(scenario)
    assert ("fenced", "zombie-a") in stamps
    assert node == ""  # the fenced bind applied nothing


def test_apiserver_rest_metrics_endpoint():
    def scenario(p):
        with rest_stack(p) as (port, _store, _client):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                return "# TYPE" in r.read().decode()

    assert _both(scenario) is True


# -- monotonic discipline ---------------------------------------------------------


def test_spans_use_monotonic_never_wall_clock():
    """Neither package's tracing.py stamps spans with time.time() (a
    wall-clock step would fabricate negative stages)."""

    def scenario(p):
        src = inspect.getsource(p.tracing)
        return "time.time()" in src, "time.monotonic()" in src

    assert _both(scenario) == (False, True)
