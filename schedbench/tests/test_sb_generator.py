"""The closed loop: the same seed makes the same pods, the unbound and
resident counts stay within their marks, and no store scan runs in the
window."""

import threading
import time

from schedbench import cluster
from schedbench.stream import PodStream
from schedbench.tests.small import ROOT, SEED, run_small

CFG = cluster.load_json(ROOT / "schedbench/configs/basic-5k.json")
TRAFFIC = cluster.load_json(ROOT / "schedbench/traffic/backlog.json")
CLOSED = cluster.load_named("loops", TRAFFIC["loop"])


def _names(seed, n):
    pool = cluster.PodPool(CFG, seed)
    return [pool.take().metadata.name for _ in range(n + 3)]


def test_same_seed_same_pods_other_seed_other_names():
    a, b = _names(SEED, 50), _names(SEED, 50)
    assert a == b and len(set(a)) == len(a)
    assert set(a).isdisjoint(_names(SEED + 1, 50))
    pool = cluster.PodPool(CFG, SEED)
    p = pool.take()
    assert p.spec.affinity is None and p.metadata.labels == {}
    # scheduler_perf's config/pod-default.yaml
    assert p.spec.containers[0].requests == {"cpu": "100m", "memory": "500Mi"}


def test_names_round_trip_and_strangers_stay_apart():
    names = cluster.Names(SEED)
    for n in (names.measured(0), names.measured(123456), "init-0", "init-999"):
        assert names.pod_name(names.pod_id(n)) == n
    other = cluster.Names(SEED + 1).measured(5)
    for n in (other, "m-x", "init-01", "stray"):
        pid = names.pod_id(n)
        assert pid >= names.OTHER_POD and names.pod_name(pid) == n
    for n in ("node-0", "node-4999", None, "node-x", "elsewhere"):
        assert names.node_name(names.node_id(n)) == n
    assert names.node_id("node-x") < -1 and names.node_id(None) == -1


class _Binder(threading.Thread):
    """Binds pending pods in batches of `batch`, as a scheduler would."""

    def __init__(self, server, batch):
        super().__init__(daemon=True)
        self.server, self.batch = server, batch
        self.stop = threading.Event()

    def run(self):
        from kubernetes_tpu_torch.api.objects import Binding

        i = 0
        while not self.stop.is_set():
            pods, _ = self.server.list("pods")
            todo = [p for p in pods if not p.spec.node_name][: self.batch]
            if len(todo) < self.batch:
                time.sleep(0.002)
                continue
            self.server.bind_pods([
                Binding(pod_name=p.metadata.name, pod_namespace=p.metadata.namespace,
                        pod_uid=p.metadata.uid, target_node=f"node-{(i + k) % 7}")
                for k, p in enumerate(todo)
            ])
            i += 1
            time.sleep(0.01)


def test_counts_stay_within_their_marks():
    from kubernetes_tpu_torch.client.apiserver import APIServer

    traffic = dict(TRAFFIC, unbound=96)
    server = APIServer()
    pool = cluster.PodPool(CFG, SEED)
    stream = PodStream(server, pool.names)
    gen = CLOSED.make(server, stream, pool, traffic, dict(CFG, resident_measured_pods=64))
    binder = _Binder(server, 32)
    gen.start()
    binder.start()
    worst_unbound = 0
    try:
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            worst_unbound = max(worst_unbound, gen.created - stream.n_bound_measured)
            time.sleep(0.001)
        binder.stop.set()
        binder.join(5)
        # the generator catches up with the last binds
        settled = None
        deadline = time.monotonic() + 10.0
        while not (settled and settled[0] == 96 and settled[1] == 64) and (
            time.monotonic() < deadline
        ):
            time.sleep(0.05)
            settled = (gen.created - stream.n_bound_measured, stream.n_bound_measured - gen.deleted)
    finally:
        binder.stop.set()
        gen.stop()
        stream.stop()
    assert stream.n_bound_measured > 300
    assert worst_unbound <= 96
    # once the binds stop, the loop is back at its marks
    assert settled[0] == 96 and settled[1] == 64, settled


def test_no_store_count_or_list_from_the_harness_inside_the_window(monkeypatch):
    from kubernetes_tpu_torch.client import apiserver

    calls = []
    for verb in ("count", "list"):
        orig = getattr(apiserver.APIServer, verb)

        def spy(self, *a, _orig=orig, _verb=verb, **kw):
            calls.append((_verb, threading.current_thread().name, time.monotonic()))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(apiserver.APIServer, verb, spy)
    res = run_small()
    w = res["window"]
    main = threading.main_thread().name
    ours = [
        c for c in calls
        if (c[1] == main or c[1].startswith("schedbench-")) and w["t_open"] <= c[2] <= w["t_close"]
    ]
    from schedbench.cell import passed

    assert res["correct"], {k: v for k, v in res["checks"].items() if not passed({k: v})}
    assert ours == []
    assert w["batches"] >= 1 and w["pods"] > 0
