"""Churn through both packages, and the port's soak
(kubernetes_tpu_torch/perf/soak.py, the counterpart of scripts/soak.py), on
the CPU.

(a) test_churn_trace_matches_reference: one seeded trace of N_OPS
    operations goes through the reference's APIServer and Scheduler (JAX on
    the CPU) and the port's (device="cpu") over N_NODES nodes of POD_LIMIT
    pods each, so the trace runs past capacity. The operations: create a
    pod (cpu 100m, a third labelled app=a0..a7), delete a live pod, cordon
    or uncordon a node, delete a node or re-add a deleted one under its
    name (the encoder reuses its freed row), create or delete svc-0..7
    (selector app=a<i>). Each operation is applied to both API servers and
    both Schedulers' informers are waited on before the next, so both see
    one event order. After every ROUND operations both Schedulers run to
    idle, driven from the test thread batch by batch as the batch parity
    of tests/test_torch_scheduler.py drives them, the port given the
    reference's own tie noise; a failed pod waits in its queue until the
    next round (both queues' backoff is set out of reach, and each round
    starts by making every queued pod active on both sides). Per batch the
    popped pods, the kernel results (masks, counts, placed and deferred
    exact; chosen nodes equal but for a near-tie shown inside TIE_EPS;
    scores within the tolerance of tests/test_torch_wavelattice.py) are
    equal; per round each pod's node, the set of pods left pending, the
    flushed ``requested``, ``sel_counts``, ``port_counts`` and
    ``prio_req``, the row names, and ``audit_device_vs_masters`` (``[]``
    on both sides). Wave and serial paths, two seeds.
(b) The soak on the CPU: ``run_soak(minutes=0.5, n_nodes=1,
    device="cpu")`` passes with its backlog past the one node's 110 pods,
    so the refill probe runs; a row corrupted in device state just before
    step C fails it, naming ``requested``; ``device=None`` raises without a
    card, naming ``device="cpu"``; the soak's scripts import neither jax
    nor the reference package.
"""

import ast
import collections
import importlib
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.client.apiserver import APIServer as RefAPIServer
from kubernetes_tpu.scheduler import scheduler as ref_sched_mod
from kubernetes_tpu.scheduler.cache.debugger import (
    audit_device_vs_masters as ref_audit_device_vs_masters,
)
from kubernetes_tpu.scheduler.config import KubeSchedulerConfiguration as RefConfig
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.perf import soak as soak_mod
from kubernetes_tpu_torch.perf.soak import Soak, host_snapshot, quiesce, run_soak
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler.cache.debugger import audit_device_vs_masters
from kubernetes_tpu_torch.scheduler.config import KubeSchedulerConfiguration
from kubernetes_tpu_torch.testing.device_faults import corrupt_device_rows
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_coscheduling import _reference_metrics_left_as_found  # noqa: F401
from test_torch_scheduler import (
    _Recorder,
    _SerialRecorder,
    _bound,
    _counter_sum,
    _settled,
    _wait,
)
from test_torch_serial_lattice import assert_serial_parity, reference_noise
from test_torch_wavelattice import assert_tie_only

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
N_NODES = 12
POD_LIMIT = 6  # pods a node: 72 in all, which the trace's creates pass
N_OPS = 400
ROUND = 20
BATCH = 16
SNAPSHOT_FIELDS = ("requested", "sel_counts", "port_counts", "prio_req")
UNREACHABLE_BACKOFF_S = 1e6


# -- (a) the churn trace --------------------------------------------------------


def make_trace(seed: int, n_ops: int = N_OPS) -> list:
    """The operations, drawn with numpy from `seed`, tracking what is live
    so that every delete names something that exists."""
    rng = np.random.default_rng(seed)
    ops, live = [], []
    next_pod = 0
    cordoned, absent, services = set(), [], set()
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.5 or not live:
            labels = {"app": f"a{int(rng.integers(8))}"} if rng.random() < 1 / 3 else {}
            ops.append(("create-pod", f"p-{next_pod}", labels))
            live.append(f"p-{next_pod}")
            next_pod += 1
        elif r < 0.7:
            ops.append(("delete-pod", live.pop(int(rng.integers(len(live))))))
        elif r < 0.82:
            n = f"n{int(rng.integers(N_NODES))}"
            if n in absent:
                continue
            ops.append(("uncordon" if n in cordoned else "cordon", n))
            cordoned ^= {n}
        elif r < 0.9:
            if absent and (rng.random() < 0.6 or len(absent) >= 2):
                n = absent.pop(0)
                ops.append(("add-node", n))
                cordoned.discard(n)
            else:
                n = f"n{int(rng.integers(N_NODES))}"
                if n not in absent:
                    ops.append(("delete-node", n))
                    absent.append(n)
        else:
            i = int(rng.integers(8))
            ops.append(("delete-service" if i in services else "create-service", i))
            services ^= {i}
    return ops


class _Side:
    """One package's API server and Scheduler under the trace."""

    def __init__(self, pkg: str, server, sched):
        self.pkg = pkg
        self.server = server
        self.sched = sched
        self.v1 = importlib.import_module(f"{pkg}.api.objects")
        self.kubelet = importlib.import_module(f"{pkg}.kubelet.kubelet")

    def node(self, name: str):
        return self.kubelet.make_node_object(name, cpu="4", pods=POD_LIMIT)

    def apply(self, op) -> None:
        v1, server = self.v1, self.server
        kind = op[0]
        if kind == "create-pod":
            _, name, labels = op
            server.create("pods", v1.Pod(
                metadata=v1.ObjectMeta(name=name, labels=dict(labels)),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
            ))
        elif kind == "delete-pod":
            server.delete("pods", "default", op[1])
        elif kind in ("cordon", "uncordon"):
            flag = kind == "cordon"
            server.guaranteed_update(
                "nodes", "", op[1], lambda n: (setattr(n.spec, "unschedulable", flag), n)[1]
            )
        elif kind == "delete-node":
            server.delete("nodes", "", op[1])
        elif kind == "add-node":
            server.create("nodes", self.node(op[1]))
        elif kind == "create-service":
            server.create("services", v1.Service(
                metadata=v1.ObjectMeta(name=f"svc-{op[1]}"),
                spec=v1.ServiceSpec(selector={"app": f"a{op[1]}"}),
            ))
        elif kind == "delete-service":
            server.delete("services", "default", f"svc-{op[1]}")
        else:
            raise ValueError(op)

    def caught_up(self) -> None:
        """The Scheduler's informers have handled every pod, node and
        service event the server has sent."""
        for kind in ("pods", "nodes", "services"):
            target = self.server.kind_resource_version(kind)
            inf = self.sched.informer_factory.informer(kind)
            deadline = time.monotonic() + 30.0
            while inf.last_resource_version < target:
                assert time.monotonic() < deadline, (
                    f"the {self.pkg} {kind} informer never reached rv {target}")
                time.sleep(0.0005)

    def activate_queued(self) -> None:
        """Every pod waiting in backoff or unschedulable goes to the active
        queue, kept in its order."""
        q = self.sched.queue
        with q._cond:
            for pi in q._backoff.list():
                q._backoff.delete_by_key(pi.key)
                q._active.add(pi)
            for key, pi in list(q._unschedulable.items()):
                del q._unschedulable[key]
                q._active.add(pi)

    def queued(self) -> set:
        return {k for ks in self.sched.queue.pending_pods().values() for k in ks}

    def flushed(self, host) -> tuple:
        """The flushed snapshot on the host, the row names and the audit
        of the snapshot against the masters, under the cache lock."""
        audit = audit_device_vs_masters if self.pkg == PACKAGES[1] else ref_audit_device_vs_masters
        with self.sched.cache.lock:
            enc = self.sched.cache.encoder
            dev = host(enc.flush())
            return dev, list(enc.row_names), audit(enc, dev, enc._masters())


def _drive_wave(ref, port, ref_rec, port_rec) -> int:
    """Both Schedulers to idle through the wave path; the near-tie chosen
    differences (each shown to be one)."""
    ties = 0
    while True:
        ref_pis = ref.queue.pop_batch(BATCH, timeout=0.0)
        port_pis = port.queue.pop_batch(BATCH, timeout=0.0)
        assert [pi.pod.metadata.name for pi in port_pis] == [
            pi.pod.metadata.name for pi in ref_pis
        ], "the queues popped different pods"
        if not ref_pis:
            if not ref._pending:
                assert not port._pending
                return ties
            ref._resolve_pending()
            port._resolve_pending()
            continue
        launches = len(ref_rec.results)
        ref.schedule_pod_batch(ref_pis)
        port.schedule_pod_batch(port_pis)
        assert len(port_rec.results) == len(ref_rec.results)
        if len(ref_rec.results) > launches:
            eb = port._pending[-1].eb if port._pending else port_rec.ebs[-1]
            ties += len(assert_tie_only(ref_rec.results[-1], port_rec.results[-1], eb.pod_tpl_np))


def _drive_serial(ref, port, ref_rec, port_rec) -> int:
    """Both Schedulers to idle through the serial path; the near-tie
    chosen differences (each shown to be one)."""
    ties = 0
    while True:
        ref_pis = ref.queue.pop_batch(BATCH, timeout=0.0)
        port_pis = port.queue.pop_batch(BATCH, timeout=0.0)
        assert [pi.pod.metadata.name for pi in port_pis] == [
            pi.pod.metadata.name for pi in ref_pis
        ], "the queues popped different pods"
        if not ref_pis:
            return ties
        launches = len(ref_rec.results)
        ref.schedule_pod_batch(ref_pis)
        port.schedule_pod_batch(port_pis)
        assert len(port_rec.results) == len(ref_rec.results)
        if len(ref_rec.results) > launches:
            ties += len(assert_serial_parity(ref_rec.results[-1], port_rec.results[-1]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_wave", [True, False], ids=["wave", "serial"])
def test_churn_trace_matches_reference(use_wave, seed):
    metrics.reset()
    trace = make_trace(seed)
    ref_server, server = RefAPIServer(), APIServer()
    sides = [_Side(PACKAGES[0], ref_server, None), _Side(PACKAGES[1], server, None)]
    for side in sides:
        for i in range(N_NODES):
            side.server.create("nodes", side.node(f"n{i}"))
    common = dict(
        device_batch_size=BATCH, antientropy_period_s=0, use_mesh=False,
        device_batch_window=0.0, pod_initial_backoff_seconds=UNREACHABLE_BACKOFF_S,
        pod_max_backoff_seconds=UNREACHABLE_BACKOFF_S,
    )
    keys = collections.deque()
    if use_wave:
        common.update(wave_m_cand=BATCH, pipeline_depth=2, vector_preemption=False)

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
    ref = ref_sched_mod.Scheduler(ref_server, RefConfig(**common))
    port = Scheduler(server, KubeSchedulerConfiguration(**common), device="cpu", **noise)
    sides[0].sched, sides[1].sched = ref, port
    if use_wave:
        ref_rec, port_rec = _Recorder(ref, True, keys), _Recorder(port, False)
    else:
        ref_rec, port_rec = _SerialRecorder(ref, True, keys), _SerialRecorder(port, False)
    drive = _drive_wave if use_wave else _drive_serial
    rounds = ties = 0
    try:
        for s in (ref, port):
            s._bringup()
        for start in range(0, len(trace), ROUND):
            for op in trace[start:start + ROUND]:
                for side in sides:
                    side.apply(op)
                for side in sides:
                    side.caught_up()
            for side in sides:
                side.activate_queued()
            ties += drive(ref, port, ref_rec, port_rec)
            for s in (ref, port):
                _wait(lambda s=s: _settled(s), 30, "the informers to confirm every bind")
                s._drain_trailing(block=True)
            rounds += 1
            where = f"seed {seed}, round {rounds} (ops {start}-{start + ROUND - 1})"
            if ties == 0:
                assert _bound(server) == _bound(ref_server), where
            else:
                assert set(_bound(server)) == set(_bound(ref_server)), where
            assert sides[1].queued() == sides[0].queued(), where
            ref_dev, ref_rows, ref_bad = sides[0].flushed(jax.device_get)
            port_dev, port_rows, port_bad = sides[1].flushed(host_snapshot)
            assert port_rows == ref_rows, where
            assert ref_bad == [] and port_bad == [], (where, ref_bad, port_bad)
            if ties == 0:
                for f in SNAPSHOT_FIELDS:
                    a = np.asarray(getattr(ref_dev, f))
                    b = getattr(port_dev, f).numpy()
                    assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
                    np.testing.assert_array_equal(b, a, err_msg=f"{where}: {f}")
            else:
                # a near-tie placed one pod on another node on each side:
                # the clusters differ from here on, so the trace stops
                break
        bound = len(_bound(server))
        pending = len(sides[1].queued())
        # the trace ran past capacity and the Schedulers placed pods
        assert pending > 0 and bound > 0
        assert len(ref_rec.results) > 0 and not keys
        assert _counter_sum("kernel_guard_trips_total") == 0
    finally:
        ref.stop()
        port.stop()


def test_trace_covers_every_operation():
    """Both seeds' traces hold every kind of operation, a node deleted
    and later re-added, and more creates than the cluster holds."""
    for seed in (0, 1):
        trace = make_trace(seed)
        kinds = collections.Counter(op[0] for op in trace)
        assert set(kinds) == {
            "create-pod", "delete-pod", "cordon", "uncordon", "delete-node",
            "add-node", "create-service", "delete-service",
        }, kinds
        assert kinds["create-pod"] - kinds["delete-pod"] > N_NODES * POD_LIMIT


# -- (b) the soak on the CPU ------------------------------------------------------


def test_soak_on_the_cpu_passes_past_capacity():
    res = run_soak(minutes=0.5, n_nodes=1, device="cpu")
    assert res.ok, res.line()
    assert res.line().startswith("SOAK PASS: created=")
    assert res.pending > 0 and res.refill_ok and res.refilled > 0
    assert res.unmarked == 0 and res.device_host_mismatch == [] and not res.errors
    assert res.retiring_clear
    assert res.audits and res.audits[-1] == {"mismatch": [], "retiring": 0.0}
    # on the CPU the samples hold the gauges and counters only
    assert res.memory_steady is None
    assert res.samples and all("memory_allocated" not in s for s in res.samples)
    assert all(s["generation_retire_stalls"] == 0 for s in res.samples)
    assert res.samples[-1]["generation_retired"] > 0
    assert res.defense["drift_rows"] == 0 and res.defense["rebuilds"] == 0
    assert res.device == "cpu" and res.n_nodes == 1


def test_corrupted_row_before_step_c_fails_the_soak_naming_requested():
    soak = Soak(n_nodes=1, device="cpu")
    try:
        soak.churn(0.1)
        soak.converge()
        # step C must meet the corrupted row: a host write to it would
        # re-scatter the row from the masters (so one still pending is
        # flushed first), and the Scheduler's own auditor repairs drift
        # within its period. Stop the auditor and the kubelets (pod status
        # and node heartbeat writes), cordon the node so that no pending
        # pod lands there, and let those writes reach the Scheduler.
        soak.sched._auditor.stop()
        soak.cluster.pool.stop()
        soak.server.guaranteed_update(
            "nodes", "", "n0", lambda n: (setattr(n.spec, "unschedulable", True), n)[1]
        )
        time.sleep(1.0)
        nodes = soak.sched.informer_factory.informer("nodes")
        assert nodes.last_resource_version >= soak.server.kind_resource_version("nodes")
        assert quiesce(soak.sched, 60.0)
        with soak.sched.cache.lock:
            enc = soak.sched.cache.encoder
            enc.flush()  # no host write left pending on the row
            corrupt_device_rows(enc, [0])
        res = soak.audit_and_gate()
    finally:
        soak.stop()
    assert not res.ok
    assert res.line().startswith("SOAK FAIL:")
    assert "requested" in res.device_host_mismatch
    assert all("requested" in a["mismatch"] for a in res.audits)


def test_run_soak_without_a_card_raises_naming_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_soak(0.01)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        soak_mod.SoakCluster(1)


@pytest.mark.parametrize("script", ["torch_soak.py", "torch_repro_mismatch.py"])
def test_soak_scripts_import_neither_jax_nor_the_reference(script):
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "kubernetes_tpu_torch.perf.soak" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "kubernetes_tpu"), name
