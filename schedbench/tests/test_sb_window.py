"""The whole-batch window over synthetic bind calls, and the clock that
times the calls."""

from schedbench.window import BIND, Run, whole_batch_window


def _calls(batches, period=1.0, t0=10.0, size=4):
    return [Run(t0 + b * period, size) for b in range(batches)]


def test_window_is_whole_batches():
    runs = _calls(30, period=3.65)
    # ready half way through the third batch's period
    w = whole_batch_window(runs, t_ready=10.0 + 2.5 * 3.65, seconds=37.0)
    assert w.t_open == 10.0 + 3 * 3.65
    # the first call at least 37 s later: 11 periods (40.15 s)
    assert w.batches == 11
    assert abs(w.seconds - 11 * 3.65) < 1e-9
    assert w.pods == 11 * 4
    assert abs(w.pods_per_s - 4 / 3.65) < 1e-9


def test_rate_does_not_depend_on_where_the_window_starts():
    runs = _calls(40, period=3.65, size=4096)
    rates = {
        round(whole_batch_window(runs, 10.0 + k * 0.37, 37.0).pods_per_s, 9)
        for k in range(30)
    }
    assert rates == {round(4096 / 3.65, 9)}


def test_uneven_batches_count_whole():
    sizes = [4096, 300, 4096, 2000, 4096, 4096, 17, 4096]
    runs = [Run(float(i), n) for i, n in enumerate(sizes)]
    w = whole_batch_window(runs, t_ready=0.5, seconds=4.0)
    # opens at t=1 (300 pods, not counted), closes at t=5
    assert (w.t_open, w.t_close) == (1.0, 5.0)
    assert w.pods == 4096 + 2000 + 4096 + 4096
    assert w.batches == 4


def test_window_waits_for_its_closing_batch():
    assert whole_batch_window(_calls(5), t_ready=9.0, seconds=10.0) is None


def test_bind_clock_times_each_call():
    from kubernetes_tpu_torch.api.objects import Binding
    from kubernetes_tpu_torch.client.apiserver import APIServer

    from schedbench import cluster
    from schedbench.stream import BindClock, PodStream
    from schedbench.tests.small import ROOT, SEED

    cfg = cluster.load_json(ROOT / "schedbench/configs/basic-5k.json")
    server = APIServer()
    pool = cluster.PodPool(cfg, SEED)
    stream = PodStream(server, pool.names)
    clock = BindClock(server)
    pods = [pool.take() for _ in range(5)]
    for p in pods:
        server.create("pods", p)

    def b(p):
        return Binding(pod_name=p.metadata.name, pod_namespace="default",
                       pod_uid=p.metadata.uid, target_node="node-0")

    server.bind_pods([b(p) for p in pods[:3]] + [b(pods[0])])  # one refused
    server.bind_pod(b(pods[3]))
    stream.stop()
    assert [r.size for r in clock.runs] == [3, 1]
    assert clock.runs[0].t <= clock.runs[1].t
    assert clock.bound == stream.n_bound == 4
    # each call's binds are the stream's binds between its two versions
    events = list(stream.events())
    for r in clock.runs:
        assert sum(1 for e in events if e[0] == BIND and r.rv0 < e[1] <= r.rv1) == r.size
