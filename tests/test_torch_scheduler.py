"""The port's Scheduler (kubernetes_tpu_torch/scheduler/scheduler.py) and
perf harness on the CPU (device="cpu"), against the reference.

(a) Deterministic batch parity. The reference Scheduler (JAX on the CPU)
    and the port's (torch on the CPU) run over equal API server contents —
    nine workloads of perf/workloads.py at 64 nodes (SchedulingPodAffinity,
    SchedulingPodAntiAffinity, SchedulingBasic,
    SchedulingPreferredPodAffinity, TopologySpreading,
    SchedulingNodeAffinity, SchedulingSecrets, SchedulingInTreePVs, whose
    pods take the host fallback, and Gang under the coscheduling profile,
    whose members park at Permit until their gang of 50 is assumed), with
    the initial pods bound up front — with every measured pod queued
    before the first batch. The test thread drives both, batch by batch,
    through the same entry (``schedule_pod_batch``; pipeline depth 2, so
    each launch resolves the previous batch) and hands the port the
    reference's own per-batch tie noise (``jax.random.uniform`` of the key
    the reference launched with). Per batch these are equal: the popped
    pods, the kernel variant (m_cand and wave count, so the small latency
    bucket shows), the placed, deferred and bound sets, and the bindings
    in the API server. A batch of at most ``small_batch_host_max`` pods
    (deferred pods coming back) takes the host path on both sides: no
    kernel runs, and the bound sets and bindings are still compared. A
    chosen node may differ only inside a TIE_EPS near-tie
    (``assert_tie_only`` of tests/test_torch_wavelattice.py).
    Two configurations: batch 16 with m_cand 16 (the small bucket equals
    the batch, so it never narrows) and batch 512 with m_cand 64 (every
    batch rides the small bucket: 256-pod pad, 32 candidates, at most 2
    waves without hard pairs).
    With a policy-gym wave ring on both Schedulers, the recorded waves are
    equal too, on the wave path here and on the serial path in (d): pod
    names, launch weights, placements, path and launch generation.
(b) The reference's threaded tests on the port: test_split_phase.py
    (binds_all_and_drains_trailing, off_restores_combined_readback,
    trailing_readback_max_validation), test_pipeline.py (the four depth
    tests, readback_failure_requeues_and_recovers) and
    test_scheduler_integration.py (basic, unschedulable_then_node_added,
    taints, anti_affinity, verify_cycles_mode_clean_run). Every threaded
    wait has its own deadline and every scheduler stops in ``finally``.
(c) The port's run_benchmark at 64 nodes: every pod bound, and every
    binding passes the reference's host filter chain (the
    ``_oracle_framework`` of tests/test_fuzz_differential.py) against the
    final cluster.

Tolerances: exact sets and bindings; float scores within the rtol/atol of
tests/test_torch_wavelattice.py where the chosen nodes agree.
"""

import collections
import importlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.client.apiserver import APIServer as RefAPIServer
from kubernetes_tpu.perf.workloads import WorkloadConfig as RefWorkloadConfig
from kubernetes_tpu.parallel import sharded as ref_sharded_mod
from kubernetes_tpu.perf.workloads import build_workload as ref_build_workload
from kubernetes_tpu.scheduler import scheduler as ref_sched_mod
from kubernetes_tpu.scheduler.cache.nodeinfo import Snapshot
from kubernetes_tpu.scheduler.config import (
    KubeSchedulerConfiguration as RefConfig,
)
from kubernetes_tpu.scheduler.framework.interface import CycleState, is_success
from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.api.objects import (
    Affinity,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    Taint,
)
from kubernetes_tpu_torch.api.selectors import LabelSelector
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.ops.lattice import GUARD_ROW_RANGE, KernelGuardTrip
from kubernetes_tpu_torch.parallel import sharded as port_sharded_mod
from kubernetes_tpu_torch.perf import harness
from kubernetes_tpu_torch.perf.harness import default_config, run_benchmark
from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler import scheduler as port_sched_mod
from kubernetes_tpu_torch.scheduler.config import KubeSchedulerConfiguration
from kubernetes_tpu_torch.utils.metrics import metrics

from test_fuzz_differential import _oracle_framework
from test_torch_wavelattice import assert_tie_only

N_NODES = 64
WORKLOADS = {
    "SchedulingPodAffinity": (16, 48),
    "SchedulingPodAntiAffinity": (8, 48),
    "SchedulingBasic": (16, 48),
    "SchedulingPreferredPodAffinity": (16, 48),
    "TopologySpreading": (16, 48),
    "SchedulingNodeAffinity": (16, 48),
    "SchedulingSecrets": (16, 48),
    "SchedulingInTreePVs": (16, 48),
    "Gang": (0, 100),
}


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _counter_sum(name):
    """A counter summed over all of its label sets."""
    return sum(
        v for k, v in metrics.dump().items()
        if k.split("{")[0] == name and not isinstance(v, dict)
    )


def _bound(server):
    return {
        p.metadata.name: p.spec.node_name
        for p in server.list("pods")[0]
        if p.spec.node_name
    }


# -- (a) deterministic batch parity ------------------------------------------


class _Recorder:
    """Wraps one scheduler's launch and commit seams: the kernel results,
    the commit-time decisions and (reference side) the launch keys."""

    def __init__(self, sched, ref: bool, keys=None):
        self.results = []  # per launch: (WaveResult, pod_tpl, names)
        self.commits = []  # per resolve: (placed, deferred, bound) names
        self.ebs = []  # per resolve: the batch's encoding
        self.keys = keys
        launch, commit = sched._launch_wave_kernel, sched._commit_batch

        def launch_rec(kern, snap, batch, ptab, weights, key):
            out = launch(kern, snap, batch, ptab, weights, key)
            if ref:
                self.keys.append(key)
                res = jax.device_get(out[1])
            else:
                res = out[1]
            self.results.append(res)
            return out

        def commit_rec(p, arrays, t_rb1=None):
            chosen, placed, deferred = (np.asarray(a) for a in arrays[:3])
            names = [pi.pod.metadata.name for pi in p.pis]
            self.ebs.append(p.eb)
            out = commit(p, arrays, t_rb1)
            self.commits.append((
                sorted(n for i, n in enumerate(names) if placed[i]),
                sorted(n for i, n in enumerate(names) if deferred[i]),
                {
                    n: p.row_names[int(chosen[i])]
                    for i, n in enumerate(names)
                    if placed[i]
                },
            ))
            return out

        sched._launch_wave_kernel = launch_rec
        sched._commit_batch = commit_rec


def _profiles(pkg, name):
    """The Gang workload runs the coscheduling profile (its Permit parks
    each gang's members until min-member are assumed), as bench.py does."""
    if name != "Gang":
        return {}
    cfg = importlib.import_module(f"{pkg}.scheduler.config")
    reg = importlib.import_module(f"{pkg}.scheduler.framework.registry")
    return dict(profiles=[cfg.ProfileConfig(plugin_set=reg.coscheduling_plugin_set())])


def _settled(s):
    """Every assumed pod is confirmed bound or parked at Permit (a gang
    below quorum). A released member stays in the framework's waiting map
    until its bind thread wakes, so it counts as parked only while its
    permit is still pending."""
    waiting = {
        wp.pod.metadata.key
        for prof in s.profiles.values()
        for wp in list(prof.framework.waiting_pods.values())
        if not wp._event.is_set()
    }
    return set(s.cache.assumed_keys()) <= waiting


def _parity_servers(name):
    n_init, n_measured = WORKLOADS[name]
    ref_nodes, ref_init, ref_fac = ref_build_workload(
        RefWorkloadConfig(name, N_NODES, n_init, n_measured)
    )
    nodes, init, fac = build_workload(
        WorkloadConfig(name, N_NODES, n_init, n_measured)
    )
    ref_server, server = RefAPIServer(), APIServer()
    for n in ref_nodes:
        ref_server.create("nodes", n)
    for n in nodes:
        server.create("nodes", n)
    # initial pods bound up front, to the same nodes on both sides
    for i, (rp, pp) in enumerate(zip(ref_init, init)):
        node = f"node-{(7 * i) % N_NODES}"
        rp.spec.node_name = node
        pp.spec.node_name = node
        ref_server.create("pods", rp)
        server.create("pods", pp)
    return (
        (ref_server, [ref_fac(i) for i in range(n_measured)]),
        (server, [fac(i) for i in range(n_measured)]),
        n_init,
    )


@pytest.mark.parametrize("batch,m_cand", [(16, 16), (512, 64)])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_scheduler_matches_reference_batch_by_batch(name, batch, m_cand, monkeypatch):
    batch_parity(name, batch, m_cand, monkeypatch)


@pytest.mark.parametrize("pod_first", [False, True])
def test_ext_generation_of_informer_order_matches_reference(pod_first):
    """Why (a) compares launch generations from a common base: a scheduled
    pod delivered before its node is parked and replayed when the node
    arrives, and the replay stamps no ext_generation. The same node and pod
    give 2 in one informer order and 1 in the other, in both packages
    alike; so two Schedulers whose pods and nodes informers interleave
    differently at bring-up start from different counts (the
    TopologySpreading case's "launch_gen 70 != 64" under a loaded run)."""
    from kubernetes_tpu.api import objects as ref_v1
    from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
    from kubernetes_tpu.scheduler.cache.cache import SchedulerCache as RefCache
    from kubernetes_tpu_torch.ops.encoding import SnapshotEncoder
    from kubernetes_tpu_torch.scheduler.cache.cache import SchedulerCache

    got = []
    for o, cache in ((ref_v1, RefCache(encoder=RefEncoder())),
                     (v1, SchedulerCache(encoder=SnapshotEncoder(device="cpu")))):
        node = o.Node(
            metadata=o.ObjectMeta(name="n0", namespace=""),
            status=o.NodeStatus(allocatable={"cpu": "8", "memory": "32Gi", "pods": 110}),
        )
        pod = o.Pod(
            metadata=o.ObjectMeta(name="p0"),
            spec=o.PodSpec(node_name="n0", containers=[o.Container(requests={"cpu": "1"})]),
        )
        for add in ((lambda: cache.add_pod(pod), lambda: cache.add_node(node)) if pod_first
                    else (lambda: cache.add_node(node), lambda: cache.add_pod(pod))):
            add()
        got.append((cache._ext_generation, cache.pod_count()))
    assert got[0] == got[1] == ((1, 1) if pod_first else (2, 1))


@pytest.mark.parametrize("batch,m_cand", [(16, 16), (512, 64)])
def test_batch_parity_holds_when_informers_lag(batch, m_cand, monkeypatch):
    """(a) on TopologySpreading with both packages' informer handlers, API
    server binds and pipeline resolves delayed at random (seeded), as a
    loaded machine delays them: the pods and nodes informers then
    interleave differently on the two sides at bring-up. Every batch, bind
    and recorded wave must still be equal (the waves' launch generations
    counted from _ext_generation_base)."""
    import random

    from kubernetes_tpu.client import apiserver as ref_apiserver
    from kubernetes_tpu.client import informers as ref_informers
    from kubernetes_tpu_torch.client import apiserver as port_apiserver
    from kubernetes_tpu_torch.client import informers as port_informers

    rng, rng_lock = random.Random(batch), threading.Lock()

    def lag(hi):
        with rng_lock:
            d = rng.uniform(0, hi) if rng.random() < 0.3 else 0.0
        time.sleep(d)

    def delayed(real, hi):
        def call(*a, **k):
            lag(hi)
            return real(*a, **k)
        return call

    for mod in (ref_apiserver, port_apiserver):
        monkeypatch.setattr(mod.APIServer, "bind_pods", delayed(mod.APIServer.bind_pods, 0.05))
    for mod in (ref_informers, port_informers):
        for hook in ("on_add", "on_update", "on_delete"):
            monkeypatch.setattr(mod._FuncHandler, hook, delayed(getattr(mod._FuncHandler, hook), 0.02))
    for mod in (ref_sched_mod, port_sched_mod):
        monkeypatch.setattr(mod.Scheduler, "_resolve_pending",
                            delayed(mod.Scheduler._resolve_pending, 0.03))
    batch_parity("TopologySpreading", batch, m_cand, monkeypatch)


def batch_parity(name, batch, m_cand, monkeypatch, mesh_devices=None, **settings):
    """The body of (a) for one workload and bucket configuration, both
    Schedulers also given `settings` (the port's also `mesh_devices`; with
    use_mesh the reference shards over its 8 virtual devices); returns the
    two (stopped) Schedulers."""
    metrics.reset()
    (ref_server, ref_pods), (server, pods), n_init = _parity_servers(name)
    common = dict(
        device_batch_size=batch, wave_m_cand=m_cand, pipeline_depth=2,
        vector_preemption=False, antientropy_period_s=0, use_mesh=False,
        device_batch_window=0.0,
    )
    common.update(settings)
    ref_variants = []
    real_jit = ref_sched_mod.make_wave_kernel_jit

    def jit_rec(*variant):
        ref_variants.append((variant[1], variant[2]))
        return real_jit(*variant)

    monkeypatch.setattr(ref_sched_mod, "make_wave_kernel_jit", jit_rec)
    port_variants = []
    real_make = port_sched_mod.make_wave_kernel

    def make_rec(*variant):
        port_variants.append((variant[1], variant[2]))
        return real_make(*variant)

    monkeypatch.setattr(port_sched_mod, "make_wave_kernel", make_rec)
    # on a mesh both sides launch the node-sharded kernel instead
    for mod, rec in ((ref_sharded_mod, ref_variants), (port_sharded_mod, port_variants)):
        real_sharded = mod.make_sharded_wave_kernel

        def sharded_rec(*variant, _real=real_sharded, _rec=rec):
            _rec.append((variant[1], variant[2]))
            return _real(*variant)

        monkeypatch.setattr(mod, "make_sharded_wave_kernel", sharded_rec)
    keys = collections.deque()
    ref = ref_sched_mod.Scheduler(
        ref_server, RefConfig(**common, **_profiles("kubernetes_tpu", name))
    )

    def ref_noise(p, m_c):
        key = keys.popleft()
        return torch.tensor(
            np.asarray(jax.random.uniform(key, (p, m_c), maxval=0.999))
        )

    port = Scheduler(
        server,
        KubeSchedulerConfiguration(**common, **_profiles("kubernetes_tpu_torch", name)),
        device="cpu", noise=ref_noise, mesh_devices=mesh_devices,
    )
    ref_rec = _Recorder(ref, True, collections.deque())
    port_rec = _Recorder(port, False)
    ref_rec.keys = keys
    rings = _attach_wave_rings(ref, port)
    try:
        for s in (ref, port):
            s._bringup()
        for s, srv, ps in ((ref, ref_server, ref_pods), (port, server, pods)):
            for p in ps:
                srv.create("pods", p)
            _wait(
                lambda s=s, ps=ps: len(s.queue) == len(ps)
                and s.cache.pod_count() == n_init,
                30, "the informers to queue every pod",
            )
        gen0 = _ext_generation_base(ref, port, n_init)
        batches, ties = 0, 0
        while True:
            ref_pis = ref.queue.pop_batch(batch, timeout=0.0)
            port_pis = port.queue.pop_batch(batch, timeout=0.0)
            assert [pi.pod.metadata.name for pi in port_pis] == [
                pi.pod.metadata.name for pi in ref_pis
            ], f"batch {batches}: the queues popped different pods"
            if not ref_pis:
                if not ref._pending:
                    break
                ref._resolve_pending()
                port._resolve_pending()
            else:
                batches += 1
                launches = len(ref_rec.results)
                ref.schedule_pod_batch(ref_pis)
                port.schedule_pod_batch(port_pis)
                assert port_variants == ref_variants, (
                    f"batch {batches}: kernel variants (m_cand, n_waves) "
                    f"{ref_variants} vs {port_variants}"
                )
                assert len(port_rec.results) == len(ref_rec.results)
                if len(ref_rec.results) > launches:
                    # batch 512 rides the small bucket: 32 candidates
                    assert port_variants[-1][0] == (32 if batch > 256 else m_cand)
                    # a batch with host-fallback pods resolves at once
                    eb = port._pending[-1].eb if port._pending else port_rec.ebs[-1]
                    diff = assert_tie_only(
                        ref_rec.results[-1], port_rec.results[-1], eb.pod_tpl_np
                    )
                    ties += len(diff)
                # else: a batch of at most small_batch_host_max pods (the
                # deferred pods coming back) took the host path on both
            for s in (ref, port):
                _wait(
                    lambda s=s: _settled(s), 30,
                    "the informers to confirm every bind",
                )
            assert len(port_rec.commits) == len(ref_rec.commits)
            for (rp, rd, rb), (pp, pd, pb) in zip(
                ref_rec.commits[-2:], port_rec.commits[-2:]
            ):
                assert (pp, pd) == (rp, rd), "placed or deferred sets differ"
                if ties == 0:
                    assert pb == rb, "chosen nodes differ"
            if ties == 0:
                assert _bound(server) == _bound(ref_server)
            else:
                assert set(_bound(server)) == set(_bound(ref_server))
        for s in (ref, port):
            s._drain_trailing(block=True)
        # batch 16 takes at least three batches; batch 512 takes one or two
        assert batches >= (3 if batch < len(pods) else 1)
        assert_same_waves(*rings, "wave", placements=ties == 0, gen0=gen0)
        assert len(_bound(server)) == len(pods) + n_init
        assert not port._trailing and not port._pending
        assert _counter_sum("kernel_guard_trips_total") == 0
    finally:
        ref.stop()
        port.stop()
    return ref, port


def _attach_wave_rings(ref, port):
    """A policy-gym wave ring on each Scheduler, large enough to keep every
    batch of a run."""
    from kubernetes_tpu.tuner.waves import WaveRingBuffer as RefRing
    from kubernetes_tpu_torch.tuner.waves import WaveRingBuffer

    ref.wave_recorder, port.wave_recorder = RefRing(4096), WaveRingBuffer(4096)
    return ref.wave_recorder, port.wave_recorder


def _ext_generation_base(ref, port, n_init):
    """Each cache's ext_generation once both sides hold every node and
    initial pod: the base their waves' launch generations are compared
    from. A bring-up's own count is not comparable across the two
    processes' informers: an initial pod that the pods informer delivers
    before the nodes informer has delivered its node is parked and
    replayed with the node unstamped (SchedulerCache.add_node), so each
    side counts one per node plus one per initial pod that came after
    its node, in whatever order its two informer threads ran."""
    base = (ref.cache._ext_generation, port.cache._ext_generation)
    n_nodes = port.cache.node_count
    for b in base:
        assert n_nodes <= b <= n_nodes + n_init, base
    return base


def assert_same_waves(ref_ring, port_ring, path, placements=True, gen0=(0, 0)):
    """The two Schedulers recorded the same waves: pod names, launch
    weights, production placements (unless a near-tie was chosen), path
    and launch generation, counted from each side's `gen0`
    (_ext_generation_base). The port's ring holds no device tensor."""
    ref_recs, port_recs = ref_ring.snapshot(), port_ring.snapshot()
    assert len(port_recs) == len(ref_recs) > 0
    for i, (r, p) in enumerate(zip(ref_recs, port_recs)):
        assert [x.metadata.name for x in p.pods] == [x.metadata.name for x in r.pods], i
        assert p.weights.dtype == r.weights.dtype
        np.testing.assert_array_equal(p.weights, r.weights)
        if placements:
            assert p.placements == r.placements, i
        assert (p.path, p.launch_gen - gen0[1], p.seq) == (
            path, r.launch_gen - gen0[0], r.seq), i
        assert r.path == path
        key = p.rng_key
        assert not (isinstance(key, torch.Tensor) and key.device.type != "cpu")


# -- (b) the reference's threaded tests on the port --------------------------


def _cfg(**kw):
    return default_config(use_mesh=False, **kw)


def _mk_server(n_nodes=10):
    server = APIServer()
    for i in range(n_nodes):
        server.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
                status=v1.NodeStatus(
                    capacity={"cpu": "16", "memory": "64Gi", "pods": "110"}
                ),
            ),
        )
    return server


def _run_pods(server, sched, n_pods, timeout_s=90.0):
    for i in range(n_pods):
        server.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name=f"p{i}"),
                spec=v1.PodSpec(
                    containers=[v1.Container(requests={"cpu": "100m"})]
                ),
            ),
        )
    _wait(
        lambda: server.count("pods", lambda p: bool(p.spec.node_name)) == n_pods,
        timeout_s, f"{n_pods} pods bound",
    )
    assert sched.wait_for_idle(30.0)


def test_split_phase_binds_all_and_drains_trailing():
    server = _mk_server()
    scfg = _cfg(pipeline_depth=2, device_batch_size=16, device_batch_window=0.02)
    trailing0 = metrics.counter("scheduler_wave_trailing_readbacks_total")
    unwound0 = metrics.counter("scheduler_wave_trailing_unwound_assumes_total")
    sched = Scheduler(server, scfg, device="cpu")
    assert sched._split_phase  # None resolves to on
    sched.start()
    try:
        _run_pods(server, sched, 48)
    finally:
        sched.stop()
    assert sched._trailing == []
    trailing1 = metrics.counter("scheduler_wave_trailing_readbacks_total")
    assert trailing1 > trailing0, "no trailing bulk validation ran"
    assert (
        metrics.counter("scheduler_wave_trailing_unwound_assumes_total")
        == unwound0
    )
    assert metrics.gauge("scheduler_wave_trailing_backlog") in (None, 0.0)


def test_split_phase_off_restores_combined_readback():
    server = _mk_server()
    scfg = _cfg(
        pipeline_depth=2, device_batch_size=16, device_batch_window=0.02,
        split_phase_readback=False,
    )
    trailing0 = metrics.counter("scheduler_wave_trailing_readbacks_total")
    sched = Scheduler(server, scfg, device="cpu")
    assert not sched._split_phase
    sched.start()
    try:
        _run_pods(server, sched, 48)
    finally:
        sched.stop()
    assert (
        metrics.counter("scheduler_wave_trailing_readbacks_total")
        == trailing0
    )


def test_trailing_readback_max_validation():
    cfg = KubeSchedulerConfiguration(trailing_readback_max=0)
    with pytest.raises(ValueError, match="trailing_readback_max"):
        cfg.validate()
    KubeSchedulerConfiguration(trailing_readback_max=1).validate()


def _run_pipeline(depth: int, batch: int = 64, pods: int = 1024):
    cfg = WorkloadConfig("SchedulingBasic", 50, 0, pods)
    scfg = _cfg(
        pipeline_depth=depth, device_batch_size=batch, device_batch_window=0.05
    )
    return run_benchmark(
        cfg, sched_config=scfg, quiet=True, timeout_s=240, device="cpu"
    )


def test_deep_pipeline_amortizes_readbacks():
    res = _run_pipeline(depth=6)
    assert res.unscheduled == 0
    assert res.n_batches >= 8, f"want a multi-batch run, got {res.n_batches}"
    assert res.readbacks_per_batch < 0.7, (
        f"readbacks/batch {res.readbacks_per_batch:.2f} — pipeline is not "
        f"amortizing ({res.n_readbacks} readbacks / {res.n_batches} batches)"
    )


def test_depth2_matches_legacy_depth1_pipeline():
    res = _run_pipeline(depth=2, pods=512)
    assert res.unscheduled == 0
    assert res.n_readbacks <= res.n_batches + 1


def test_synchronous_depth1_still_schedules_all():
    res = _run_pipeline(depth=1, pods=256)
    assert res.unscheduled == 0


def test_deep_pipeline_device_host_convergence():
    """After a deep-pipelined burst fully resolves, the on-device snapshot
    (updated in place by every launch) must EQUAL the host masters."""
    server = APIServer()
    for i in range(20):
        server.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
                status=v1.NodeStatus(
                    capacity={"cpu": "32", "memory": "128Gi", "pods": "200"}
                ),
            ),
        )
    scfg = _cfg(pipeline_depth=6, device_batch_size=32, device_batch_window=0.02)
    sched = Scheduler(server, scfg, device="cpu")
    sched.start()
    try:
        for i in range(300):
            server.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(
                        name=f"p{i}", labels={"app": f"a{i % 3}"}
                    ),
                    spec=v1.PodSpec(
                        containers=[v1.Container(requests={"cpu": "100m"})]
                    ),
                ),
            )
        _wait(
            lambda: server.count("pods", lambda p: bool(p.spec.node_name)) == 300,
            60, "300 pods bound",
        )
        assert sched.wait_for_idle(30.0)
        with sched.cache.lock:
            enc = sched.cache.encoder
            dev = enc.flush()
            masters = enc._masters()
        for fld in ("requested", "sel_counts", "port_counts", "prio_req"):
            d = getattr(dev, fld).cpu().numpy()
            h = np.asarray(getattr(masters, fld))
            assert np.array_equal(d, h), (
                f"device/host diverged on {fld}: "
                f"{np.abs(d.astype(np.int64) - h.astype(np.int64)).max()}"
            )
    finally:
        sched.stop()


def test_readback_failure_requeues_and_recovers():
    """A failure of the index readback must requeue the in-flight pods,
    invalidate the device snapshot (rebuilt from the host masters), and
    let the next cycle schedule them — no pod lost, no double commit."""
    server = APIServer()
    for i in range(5):
        server.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
                status=v1.NodeStatus(
                    capacity={"cpu": "16", "memory": "64Gi", "pods": "110"}
                ),
            ),
        )
    scfg = _cfg(pipeline_depth=2, device_batch_size=64)
    sched = Scheduler(server, scfg, device="cpu")
    real_fetch = sched._fetch_wave_index
    fail_once = {"armed": False, "fired": 0}

    def flaky_fetch(batches):
        if fail_once["armed"]:
            fail_once["armed"] = False
            fail_once["fired"] += 1
            raise RuntimeError("injected readback failure")
        return real_fetch(batches)

    sched._fetch_wave_index = flaky_fetch
    sched.start()
    try:
        # armed before the pods arrive: the port's CPU run binds 100 pods
        # in well under the reference's 0.3 s arming delay. The first
        # readback dies; the next batch's binds move the requeued pods
        # back to the active queue.
        fail_once["armed"] = True
        for i in range(100):
            server.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"p{i}"),
                    spec=v1.PodSpec(
                        containers=[v1.Container(requests={"cpu": "100m"})]
                    ),
                ),
            )
        _wait(
            lambda: server.count("pods", lambda p: bool(p.spec.node_name)) == 100,
            60, "100 pods bound after the injected failure",
        )
        assert fail_once["fired"] == 1
    finally:
        sched.stop()


def make_node(name, cpu="4", mem="32Gi", labels=None, taints=None):
    return Node(
        metadata=ObjectMeta(name=name, namespace="", labels=labels or {}),
        spec=NodeSpec(taints=taints or []),
        status=NodeStatus(allocatable={"cpu": cpu, "memory": mem, "pods": 110}),
    )


def make_pod(name, cpu="100m", mem="128Mi", labels=None, **spec_kw):
    return Pod(
        metadata=ObjectMeta(name=name, labels=labels or {}),
        spec=PodSpec(
            containers=[Container(requests={"cpu": cpu, "memory": mem})], **spec_kw
        ),
    )


def wait_scheduled(server, names, timeout=60.0):
    out = {}

    def done():
        pods = {p.metadata.name: p for p in server.list("pods")[0]}
        if all(n in pods and pods[n].spec.node_name for n in names):
            out.update({n: pods[n].spec.node_name for n in names})
            return True
        return False

    _wait(done, timeout, f"pods {names} scheduled")
    return out


@pytest.fixture(params=["device", "host"])
def sched_env(request):
    server = APIServer()
    sched = Scheduler(
        server, _cfg(use_device=request.param == "device"), device="cpu"
    )
    sched.start()
    try:
        yield server, sched
    finally:
        sched.stop()


def test_end_to_end_basic(sched_env):
    server, sched = sched_env
    for i in range(4):
        server.create("nodes", make_node(f"n{i}"))
    for i in range(20):
        server.create("pods", make_pod(f"p{i}"))
    placed = wait_scheduled(server, [f"p{i}" for i in range(20)])
    assert len(set(placed.values())) == 4  # spread over all nodes
    _wait(
        lambda: any(e.reason == "Scheduled" for e in server.list("events")[0]),
        5, "a Scheduled event",
    )


def test_end_to_end_unschedulable_then_node_added(sched_env):
    server, sched = sched_env
    server.create("nodes", make_node("small", cpu="1"))
    server.create("pods", make_pod("big", cpu="2"))

    def conds():
        pod = server.get("pods", "default", "big")
        return {c.type: c for c in pod.status.conditions}

    _wait(lambda: "PodScheduled" in conds(), 60, "a PodScheduled condition")
    assert server.get("pods", "default", "big").spec.node_name == ""
    assert conds()["PodScheduled"].reason == "Unschedulable"
    server.create("nodes", make_node("big-node", cpu="8"))
    placed = wait_scheduled(server, ["big"])
    assert placed["big"] == "big-node"


def test_end_to_end_taints(sched_env):
    server, sched = sched_env
    server.create(
        "nodes", make_node("t", taints=[Taint("dedicated", "x", "NoSchedule")])
    )
    server.create("nodes", make_node("open"))
    server.create("pods", make_pod("p"))
    placed = wait_scheduled(server, ["p"])
    assert placed["p"] == "open"


def test_end_to_end_anti_affinity(sched_env):
    server, sched = sched_env
    server.create("nodes", make_node("n0", labels={"zone": "z0"}))
    server.create("nodes", make_node("n1", labels={"zone": "z1"}))
    anti = Affinity(
        pod_anti_affinity=PodAntiAffinity(
            required=(
                PodAffinityTerm(
                    label_selector=LabelSelector.make(match_labels={"app": "web"}),
                    topology_key="zone",
                ),
            )
        )
    )
    server.create("pods", make_pod("w0", labels={"app": "web"}, affinity=anti))
    server.create("pods", make_pod("w1", labels={"app": "web"}, affinity=anti))
    placed = wait_scheduled(server, ["w0", "w1"])
    assert placed["w0"] != placed["w1"]
    server.create("pods", make_pod("w2", labels={"app": "web"}, affinity=anti))
    time.sleep(0.5)
    assert server.get("pods", "default", "w2").spec.node_name == ""


def test_verify_cycles_mode_clean_run():
    metrics.reset()
    server = APIServer()
    sched = Scheduler(server, _cfg(use_device=True, verify_cycles=True), device="cpu")
    sched.start()
    try:
        for i in range(3):
            server.create(
                "nodes",
                make_node(f"n{i}", labels={"zone": f"z{i % 2}"},
                          taints=[Taint("dedicated", "infra", "NoSchedule")]
                          if i == 2 else []),
            )
        for i in range(12):
            server.create("pods", make_pod(f"v{i}", cpu="200m"))
        placed = wait_scheduled(server, [f"v{i}" for i in range(12)])
        assert "n2" not in placed.values()
        mismatches = {
            k: v for k, v in metrics.dump().items() if "verify_mismatch" in k
        }
        assert not mismatches, mismatches
    finally:
        sched.stop()


def test_preemption_end_to_end(sched_env):
    server, sched = sched_env
    server.create("nodes", make_node("only", cpu="2"))
    low = make_pod("low", cpu="1500m")
    low.spec.priority = 0
    server.create("pods", low)
    wait_scheduled(server, ["low"])
    high = make_pod("high", cpu="1500m")
    high.spec.priority = 1000
    server.create("pods", high)
    placed = wait_scheduled(server, ["high"])
    assert placed["high"] == "only"
    # victim got deleted
    pods = {p.metadata.name for p in server.list("pods")[0]}
    assert "low" not in pods


def test_device_preemption_candidates_come_from_the_whatif_mask(caplog):
    """A pod that fails on the device path preempts through _finish_batch:
    with vector preemption off, the port's what-if mask narrows the
    candidates to the nodes where evicting lower-priority pods makes room
    (not the tainted node, not the node whose only pod outranks the
    preemptor), and the victim is one of theirs."""
    server = APIServer()
    sched = Scheduler(
        server,
        _cfg(use_device=True, small_batch_host_max=0, vector_preemption=False),
        device="cpu",
    )
    masks = []
    real = sched._preempt_whatif_tpl

    def spy(eb, failed, pod_tpl):
        mask = real(eb, failed, pod_tpl)
        masks.append((mask, [int(pod_tpl[i]) for _pi, i in failed]))
        return mask

    sched._preempt_whatif_tpl = spy
    for name in ("a", "b", "c"):
        server.create("nodes", make_node(name, cpu="2"))
    server.create(
        "nodes", make_node("t", cpu="2", taints=[Taint("dedicated", "x", "NoSchedule")])
    )
    for name, node, prio in (
        ("low-a", "a", 0), ("low-b", "b", 0), ("top-c", "c", 2000), ("low-t", "t", 0)
    ):
        server.create("pods", make_pod(name, cpu="1500m", priority=prio, node_name=node))
    sched.start()
    try:
        with caplog.at_level("ERROR"):
            server.create("pods", make_pod("urgent", cpu="1500m", priority=1000))
            placed = wait_scheduled(server, ["urgent"])
        assert placed["urgent"] in ("a", "b")
        pods = {p.metadata.name for p in server.list("pods")[0]}
        assert pods == {"urgent", "top-c", "low-t", "low-a", "low-b"} - {
            f"low-{placed['urgent']}"
        }
        assert masks and masks[0][0] is not None
        mask, tpls = masks[0]
        rows = sched.cache.encoder.row_names
        assert {rows[r] for r in np.flatnonzero(mask[tpls[0]])} == {"a", "b"}
        assert not [r for r in caplog.records if r.levelname == "ERROR"]
    finally:
        sched.stop()


def _trip_first_commit(monkeypatch):
    """Make the first wave batch's commit fail the kernel-output guards;
    returns the commit-call counter."""
    calls = {"n": 0}
    real = port_sched_mod.Scheduler._commit_batch

    def commit(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise KernelGuardTrip(GUARD_ROW_RANGE, "injected")
        return real(self, *a, **kw)

    monkeypatch.setattr(port_sched_mod.Scheduler, "_commit_batch", commit)
    return calls


def test_guard_trip_requeues_the_batch_for_the_device(monkeypatch):
    """The reference's answer to a kernel-output guard trip, held against
    the reference (the name predates it: until the data-plane defense was
    ported, a tripped batch was requeued for the device). Both Schedulers
    are driven batch by batch at 64 nodes with the reference's tie noise,
    their first `k` commits made to trip the guards. k = 1: the tripped
    batch goes to the host path, the newer in-flight batch is pulled with
    `sibling_quarantine`, the device stays up. k = device_loss_disable_after
    (3): the consecutive trips latch the device down and every later batch
    takes the host path. Both sides host-schedule the same pods and bind
    every pod to the same node, with the same trips by reason."""
    from test_torch_device_defense import _drive_pair, _series

    from kubernetes_tpu.ops.lattice import KernelGuardTrip as RefTrip
    from kubernetes_tpu.utils.metrics import metrics as ref_metrics

    for k in (1, 3):
        metrics.reset()
        ref_metrics.reset()
        (ref_server, ref_pods), (server, pods), n_init = _parity_servers(
            "SchedulingPodAffinity"
        )
        common = dict(
            device_batch_size=16, wave_m_cand=16, pipeline_depth=2,
            antientropy_period_s=0, use_mesh=False, device_batch_window=0.0,
            pod_initial_backoff_seconds=0.05, pod_max_backoff_seconds=0.1,
        )
        ref = ref_sched_mod.Scheduler(ref_server, RefConfig(**common))
        keys = collections.deque()
        port = Scheduler(
            server, KubeSchedulerConfiguration(**common), device="cpu",
            noise=lambda p, m_c: torch.tensor(np.asarray(
                jax.random.uniform(keys.popleft(), (p, m_c), maxval=0.999)
            )),
        )
        host = {"ref": [], "port": []}
        for side, s, trip in (("ref", ref, RefTrip), ("port", port, KernelGuardTrip)):
            calls = {"n": 0}
            commit, one_host = s._commit_batch, s._schedule_one_host

            def tripping_commit(*a, _c=calls, _commit=commit, _trip=trip, **kw):
                _c["n"] += 1
                if _c["n"] <= k:
                    raise _trip(GUARD_ROW_RANGE, "injected")
                return _commit(*a, **kw)

            def recording_host(pi, moves, _side=side, _one=one_host):
                host[_side].append(pi.pod.metadata.name)
                return _one(pi, moves)

            s._commit_batch = tripping_commit
            s._schedule_one_host = recording_host
        launch = ref._launch_wave_kernel

        def launch_rec(kern, snap, batch, ptab, weights, key):
            keys.append(key)
            return launch(kern, snap, batch, ptab, weights, key)

        ref._launch_wave_kernel = launch_rec
        try:
            for s in (ref, port):
                s._bringup()
            for s, srv, ps in ((ref, ref_server, ref_pods), (port, server, pods)):
                for p in ps:
                    srv.create("pods", p)
                _wait(
                    lambda s=s, ps=ps: len(s.queue) == len(ps)
                    and s.cache.pod_count() == n_init,
                    30, "the informers to queue every pod",
                )
            _drive_pair(ref, port, ref_server, server, 16)
            assert host["port"] == host["ref"]
            if k == 1:
                assert sorted(host["port"]) == sorted(
                    pi.metadata.name for pi in pods[:16]
                ), "the tripped batch did not go to the host path"
            else:
                assert len(host["port"]) == len(pods)
            assert _bound(server) == _bound(ref_server)
            assert len(_bound(server)) == len(pods) + n_init
            assert _series(metrics) == _series(ref_metrics)
            trips = {
                labels["reason"]: v
                for _n, labels, v in metrics.snapshot_counters(
                    "kernel_guard_trips_total"
                )
            }
            assert trips[GUARD_ROW_RANGE] == k
            assert trips["sibling_quarantine"] >= 1
            assert port._device_down == ref._device_down == (k == 3)
        finally:
            ref.stop()
            port.stop()


@pytest.mark.parametrize("entry", ["run_benchmark", "run_latency_benchmark"])
def test_harness_fails_a_run_with_guard_trips(entry, monkeypatch):
    """The harness's results carry the run's guard trips and unwound
    assumes, and a run with either above 0 raises KernelGuardFailure,
    even though every pod was bound in the end."""
    _trip_first_commit(monkeypatch)
    cfg = WorkloadConfig("SchedulingBasic", 8, 4, 8)
    scfg = _cfg(device_batch_size=16, small_batch_host_max=0)
    with pytest.raises(harness.KernelGuardFailure) as err:
        if entry == "run_benchmark":
            run_benchmark(cfg, sched_config=scfg, device="cpu", timeout_s=60)
        else:
            harness.run_latency_benchmark(
                cfg, 20.0, n_pods=8, sched_config=scfg, timeout_s=60,
                device="cpu",
            )
    res = err.value.result
    assert res.guard_trips >= 1 and res.unwound_assumes == 0
    assert res.scheduled == 8


@pytest.mark.parametrize("entry", ["run_benchmark", "run_latency_benchmark"])
def test_harness_fails_a_run_whose_device_latched_down(entry, monkeypatch):
    """Every wave launch is lost: the first loss latches the device down
    (device_loss_disable_after=1) and the host path binds every pod, but
    the run raises KernelGuardFailure naming the latch, its result
    carrying device_down = 1 and the auditor's counts."""
    from kubernetes_tpu_torch.parallel.sharded import DeviceLossError

    def lost(self, *a, **kw):
        raise DeviceLossError("injected: device lost")

    monkeypatch.setattr(port_sched_mod.Scheduler, "_launch_wave_kernel", lost)
    cfg = WorkloadConfig("SchedulingBasic", 8, 4, 8)
    scfg = _cfg(
        device_batch_size=16, small_batch_host_max=0,
        device_retry_attempts=0, device_loss_disable_after=1,
        pod_initial_backoff_seconds=0.1,
    )
    with pytest.raises(harness.KernelGuardFailure) as err:
        if entry == "run_benchmark":
            run_benchmark(cfg, sched_config=scfg, device="cpu", timeout_s=60)
        else:
            harness.run_latency_benchmark(
                cfg, 20.0, n_pods=8, sched_config=scfg, timeout_s=60,
                device="cpu",
            )
    assert err.value.failed == {"device_down": 1}
    res = err.value.result
    assert res.device_down == 1 and res.scheduled == 8
    assert res.drift_rows == 0 and res.rebuilds == 0


# -- entry-point rules ------------------------------------------------------


@pytest.mark.parametrize(
    "override,item",
    [
        (dict(use_mesh=True), 6),
    ],
)
def test_unported_settings_raise_with_their_roadmap_item(override, item, monkeypatch):
    """The last refused setting, a mesh over more than one card (ROADMAP
    queue 1 `item`), is ported: nothing is refused any more, with two
    cards faked (the check is asked directly, so it runs without a card)
    or on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for dev in (torch.device("cuda"), torch.device("cpu")):
        unported = port_sched_mod._unported_settings(
            KubeSchedulerConfiguration(**override), dev
        )
        assert item not in [i for _what, i in unported]
        assert unported == []


@pytest.mark.parametrize(
    "override",
    [
        dict(host_callback_binds=True),
        dict(antientropy_period_s=0.05),
        dict(tune_policy=True),
    ],
    ids=["host_callback_binds", "antientropy", "tune_policy"],
)
def test_formerly_unported_settings_construct_and_bind(override):
    """Settings the port once refused run: a Scheduler with any of them
    constructs, binds every pod, and (the auditor) completes passes with
    no drift, (host callbacks) takes every fast payload from a delivery,
    or (tune_policy, which cmd/scheduler.run reads to start the gym)
    records every wave batch it commits into an attached ring."""
    metrics.reset()
    server = _mk_server(4)
    sched = Scheduler(server, _cfg(**override), device="cpu")
    if "tune_policy" in override:
        from kubernetes_tpu_torch.tuner.waves import WaveRingBuffer

        sched.wave_recorder = WaveRingBuffer(1024)
    sched.start()
    try:
        _run_pods(server, sched, 40)
        if "tune_policy" in override:
            recs = sched.wave_recorder.snapshot()
            assert sum(len(r.pods) for r in recs) == 40
            assert all(r.path == "wave" and all(r.placements) for r in recs)
            assert metrics.counter("scheduler_wave_batches_total") == len(recs)
        elif "antientropy_period_s" in override:
            _wait(
                lambda: metrics.counter("snapshot_audit_passes_total") >= 2,
                10, "two audit passes",
            )
            assert _counter_sum("snapshot_drift_rows_total") == 0
            assert _counter_sum("snapshot_rebuilds_total") == 0
        else:
            delivered = metrics.counter("scheduler_wave_hostcb_deliveries_total")
            assert delivered == metrics.counter("scheduler_wave_batches_total") > 0
    finally:
        sched.stop()


def test_entry_points_raise_without_a_card():
    assert not torch.cuda.is_available()
    cfg = WorkloadConfig("SchedulingBasic", 4, 0, 4)
    for call in (
        lambda: Scheduler(APIServer(), _cfg()),
        lambda: run_benchmark(cfg),
        lambda: harness.run_latency_benchmark(cfg, 10.0, n_pods=1),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# -- (c) run_benchmark on the CPU, every binding through the host oracle -----


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_run_benchmark_bindings_pass_reference_host_filters(name):
    n_init, n_measured = WORKLOADS[name]
    cfg = WorkloadConfig(name, N_NODES, n_init, n_measured)
    server = APIServer()
    res = run_benchmark(
        cfg,
        sched_config=_cfg(device_batch_size=32, wave_m_cand=16),
        device="cpu", timeout_s=60, server=server,
    )
    assert res.unscheduled == 0 and res.scheduled == n_measured
    ref_nodes, ref_init, ref_fac = ref_build_workload(
        RefWorkloadConfig(name, N_NODES, n_init, n_measured)
    )
    # the reference's own pod objects, bound where the port bound them
    ref_by_name = {p.metadata.name: p for p in ref_init}
    ref_by_name.update((f"pod-{i}", ref_fac(i)) for i in range(n_measured))
    bound = []
    for p in server.list("pods")[0]:
        assert p.spec.node_name, p.metadata.name
        rp = ref_by_name[p.metadata.name].deep_copy()
        rp.spec.node_name = p.spec.node_name
        bound.append(rp)
    assert len(bound) == len(ref_by_name)
    for p in bound:
        if not p.metadata.name.startswith("pod-"):
            continue
        others = [q for q in bound if q is not p]
        snapshot = Snapshot.from_literals(others, ref_nodes)
        fw = _oracle_framework([snapshot])
        state = CycleState()
        assert is_success(fw.run_pre_filter_plugins(state, p)), p.metadata.name
        st = fw.run_filter_plugins(state, p, snapshot.get(p.spec.node_name))
        assert is_success(st), (p.metadata.name, p.spec.node_name, st)


def test_run_benchmark_trace_dir_writes_a_profiler_trace(tmp_path):
    """trace_dir (the reference's xplane_dir) records the run body with
    torch.profiler and exports a Chrome trace; the run itself is unchanged."""
    import json

    cfg = WorkloadConfig("SchedulingBasic", 8, 4, 16)
    res = run_benchmark(
        cfg, sched_config=_cfg(device_batch_size=16), device="cpu",
        timeout_s=60, trace_dir=str(tmp_path),
    )
    assert res.unscheduled == 0 and res.scheduled == 16
    trace = json.loads((tmp_path / "harness_trace.json").read_text())
    assert trace["traceEvents"], "the profiler recorded no events"


# -- (d) the serial lattice, vector preemption and the warm standby ----------


def test_reference_default_configuration_constructs():
    """The reference's bare defaults (vector preemption and the snapshot
    auditor on) construct, with use_wave on and off."""
    for cfg in (
        KubeSchedulerConfiguration(),
        KubeSchedulerConfiguration(use_wave=False),
    ):
        assert cfg.vector_preemption and cfg.antientropy_period_s > 0
        sched = Scheduler(APIServer(), cfg, device="cpu")
        sched.stop()


class _SerialRecorder:
    """Wraps one scheduler's serial launch seam: the kernel results and
    (reference side) the launch keys with the batch's shape."""

    def __init__(self, sched, ref: bool, keys=None):
        self.results = []
        real = sched._run_serial_kernel

        def rec(kern, snap, batch, key_or_noise, weights=None):
            out = real(kern, snap, batch, key_or_noise, weights)
            if ref:
                keys.append(
                    (key_or_noise, batch.valid.shape[0], snap.valid.shape[0])
                )
                self.results.append(jax.device_get(out[0]))
            else:
                self.results.append(out[0])
            return out

        sched._run_serial_kernel = rec


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_serial_scheduler_matches_reference_batch_by_batch(name):
    """use_wave=False on both sides, driven batch by batch as in (a), the
    port given the reference's per-pod tie noise: every serial kernel
    result (chosen, feasible_count, resolvable exact; score within the
    stated tolerance), the bound sets and the bindings are equal."""
    serial_parity(name)


def serial_parity(name, mesh_devices=None, **settings):
    """The body of the serial batch parity for one workload, both
    Schedulers also given `settings` (the port's also `mesh_devices`);
    returns the two (stopped) Schedulers."""
    from test_torch_serial_lattice import assert_serial_parity, reference_noise

    metrics.reset()
    (ref_server, ref_pods), (server, pods), n_init = _parity_servers(name)
    common = dict(
        use_wave=False, device_batch_size=16, antientropy_period_s=0,
        use_mesh=False, device_batch_window=0.0,
    )
    common.update(settings)
    keys = collections.deque()
    ref = ref_sched_mod.Scheduler(
        ref_server, RefConfig(**common, **_profiles("kubernetes_tpu", name))
    )

    def serial_noise(p, n):
        key, rp, rn = keys.popleft()
        assert (rp, rn) == (p, n)
        return torch.tensor(reference_noise(key, p, n))

    port = Scheduler(
        server,
        KubeSchedulerConfiguration(**common, **_profiles("kubernetes_tpu_torch", name)),
        device="cpu", serial_noise=serial_noise, mesh_devices=mesh_devices,
    )
    ref_rec = _SerialRecorder(ref, True, keys)
    port_rec = _SerialRecorder(port, False)
    rings = _attach_wave_rings(ref, port)
    try:
        for s in (ref, port):
            s._bringup()
        for s, srv, ps in ((ref, ref_server, ref_pods), (port, server, pods)):
            for p in ps:
                srv.create("pods", p)
            _wait(
                lambda s=s, ps=ps: len(s.queue) == len(ps)
                and s.cache.pod_count() == n_init,
                30, "the informers to queue every pod",
            )
        gen0 = _ext_generation_base(ref, port, n_init)
        batches = 0
        while True:
            ref_pis = ref.queue.pop_batch(16, timeout=0.0)
            port_pis = port.queue.pop_batch(16, timeout=0.0)
            assert [pi.pod.metadata.name for pi in port_pis] == [
                pi.pod.metadata.name for pi in ref_pis
            ], f"batch {batches}: the queues popped different pods"
            if not ref_pis:
                break
            batches += 1
            launches = len(ref_rec.results)
            ref.schedule_pod_batch(ref_pis)
            port.schedule_pod_batch(port_pis)
            assert len(port_rec.results) == len(ref_rec.results)
            # a last batch of at most small_batch_host_max pods takes the
            # host path on both
            if len(ref_rec.results) > launches:
                diff = assert_serial_parity(ref_rec.results[-1], port_rec.results[-1])
                assert diff.size == 0, f"batch {batches}: chosen differs at {diff}"
            else:
                assert len(ref_pis) <= ref.cfg.small_batch_host_max
            for s in (ref, port):
                _wait(
                    lambda s=s: _settled(s), 30,
                    "the informers to confirm every bind",
                )
            assert _bound(server) == _bound(ref_server)
        assert batches == -(-len(pods) // 16)
        assert len(_bound(server)) == len(pods) + n_init
        assert not keys and not port._trailing
        assert_same_waves(*rings, "serial", gen0=gen0)
        assert _counter_sum("kernel_guard_trips_total") == 0
    finally:
        ref.stop()
        port.stop()
    return ref, port


def _preempt_cluster(o, server, n_nodes, n_hi):
    """A FULL cluster (4 x 1-cpu priority-0 pods pre-bound on each 4-cpu
    node) and a pending burst of 2-cpu priority-100 pods, in package o's
    objects."""
    for i in range(n_nodes):
        server.create(
            "nodes",
            o.Node(
                metadata=o.ObjectMeta(name=f"n{i}", namespace=""),
                status=o.NodeStatus(
                    allocatable={"cpu": "4", "memory": "16Gi", "pods": 32}
                ),
            ),
        )
        for k in range(4):
            server.create(
                "pods",
                o.Pod(
                    metadata=o.ObjectMeta(
                        name=f"low-{i}-{k}", labels={"app": "web"}
                    ),
                    spec=o.PodSpec(
                        containers=[o.Container(requests={"cpu": "1"})],
                        priority=0,
                        node_name=f"n{i}",
                    ),
                ),
            )
    for i in range(n_hi):
        server.create(
            "pods",
            o.Pod(
                metadata=o.ObjectMeta(name=f"hi-{i}"),
                spec=o.PodSpec(
                    containers=[o.Container(requests={"cpu": "2"})],
                    priority=100,
                ),
            ),
        )


def _preemption_outcome(server):
    pods = server.list("pods")[0]
    return (
        sorted(p.metadata.name for p in pods if p.metadata.name.startswith("low-")),
        {
            p.metadata.name: p.status.nominated_node_name
            for p in pods
            if p.metadata.name.startswith("hi-")
        },
    )


@pytest.mark.parametrize("n_nodes,n_hi", [(6, 6), (10, 10)])
def test_vector_preemption_matches_reference(n_nodes, n_hi):
    """The happy path (6 preemptors over 6 full nodes) and the sibling
    burst (10 preemptors, more than the kernel's top-K) of
    tests/test_preemptlattice.py, driven on both sides through one wave
    batch: the batched victim selection runs, and the surviving pods (so
    the victims evicted) and the nominated nodes are the reference's.
    Then both loops run until every preemptor is bound, on distinct
    nodes."""
    from kubernetes_tpu.api import objects as ref_v1
    from kubernetes_tpu.utils.metrics import metrics as ref_metrics

    metrics.reset()
    ref_server, server = RefAPIServer(), APIServer()
    _preempt_cluster(ref_v1, ref_server, n_nodes, n_hi)
    _preempt_cluster(v1, server, n_nodes, n_hi)
    common = dict(antientropy_period_s=0, use_mesh=False, device_batch_window=0.0)
    ref = ref_sched_mod.Scheduler(ref_server, RefConfig(**common))
    port = Scheduler(server, KubeSchedulerConfiguration(**common), device="cpu")
    ref_counter = lambda n: ref_metrics.counter(n)  # noqa: E731
    base = {
        n: ref_counter(n)
        for n in (
            "scheduler_preemption_batches_total",
            "scheduler_preemption_vector_hits_total",
            "scheduler_preemption_oracle_divergence_total",
        )
    }
    try:
        for s in (ref, port):
            s._bringup()
            _wait(
                lambda s=s: len(s.queue) == n_hi
                and s.cache.pod_count() == 4 * n_nodes,
                30, "the informers to sync",
            )
        ref_pis = ref.queue.pop_batch(64, timeout=0.0)
        port_pis = port.queue.pop_batch(64, timeout=0.0)
        assert [pi.pod.metadata.name for pi in port_pis] == [
            pi.pod.metadata.name for pi in ref_pis
        ]
        assert len(ref_pis) == n_hi
        for s, pis in ((ref, ref_pis), (port, port_pis)):
            s.schedule_pod_batch(pis)
            s._resolve_pending()
        want = _preemption_outcome(ref_server)
        got = _preemption_outcome(server)
        assert got == want
        assert len(want[0]) < 4 * n_nodes  # victims were evicted
        assert sum(1 for n in want[1].values() if n) == n_hi
        for n, v in base.items():
            assert metrics.counter(n) == ref_counter(n) - v, n
        assert metrics.counter("scheduler_preemption_batches_total") == 1
        assert metrics.counter("scheduler_preemption_vector_hits_total") >= 1
        assert metrics.counter("scheduler_preemption_oracle_divergence_total") == 0

        for s in (ref, port):
            s.promote()
        for srv in (ref_server, server):
            _wait(
                lambda srv=srv: len(
                    {n for name, n in _bound(srv).items() if name.startswith("hi-")}
                ) == n_hi,
                90, "every preemptor bound on its own node",
            )
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("corruption", ["row_out_of_range", "empty_victims"])
def test_seeded_disagreement_trips_guard_and_falls_back(corruption):
    """tests/test_preemptlattice.py's seeded disagreement on the port: a
    corrupted victim-selection readback trips the preemption guard
    (counted), every preemptor still preempts and binds through the host
    walk, nothing is evicted from the corrupted answer, and no
    high-priority pod is evicted."""
    metrics.reset()
    server = APIServer()
    sched = Scheduler(server, _cfg(), device="cpu")
    real = sched._run_preempt_kernel

    def corrupted(snap, batch, prios):
        out = real(snap, batch, prios)
        if corruption == "row_out_of_range":
            out["node"] = out["node"].copy()
            out["node"][out["node"] >= 0] = 10_000
        else:
            out["victims"] = np.zeros_like(out["victims"])
        return out

    sched._run_preempt_kernel = corrupted
    for i in range(5):
        server.create("nodes", make_node(f"n{i}"))
    for i in range(5):
        for k in range(4):
            server.create(
                "pods", make_pod(f"low-{i}-{k}", cpu="1", labels={"app": "web"})
            )
    sched.start()
    try:
        wait_scheduled(server, [f"low-{i}-{k}" for i in range(5) for k in range(4)])
        # a batch of 6 > small_batch_host_max keeps the burst on the wave
        # path, where the vector engine lives
        hi = [f"hi-{i}" for i in range(6)]
        for n in hi:
            p = make_pod(n, cpu="2")
            p.spec.priority = 100
            server.create("pods", p)
        wait_scheduled(server, hi, timeout=90)
        assert _counter_sum("scheduler_preemption_guard_trips_total") >= 1
        assert metrics.counter("scheduler_preemption_vector_hits_total") == 0
        names = [p.metadata.name for p in server.list("pods")[0]]
        assert sum(1 for n in names if n.startswith("hi-")) == 6
    finally:
        sched.stop()


def test_run_preemption_benchmark_on_the_cpu():
    """run_preemption_benchmark at 16 nodes and a 16-pod burst: every
    preemptor bound through the batched pass, no kernel error, no guard
    trip, no divergence."""
    res = harness.run_preemption_benchmark(16, 16, timeout_s=60, device="cpu")
    assert res.scheduled == 16 and res.burst_pods == 16
    assert res.select_batches >= 1 and res.vector_attempts > 0
    assert res.fallbacks_by_reason.get("kernel_error", 0) == 0
    assert res.guard_trips == 0 and res.oracle_divergences == 0
    assert res.victims_evicted >= 2 * 16  # two 1-cpu victims per preemptor


def test_standby_promote_adopts_like_reference():
    """tests/test_chaos_ha.py's warm-up scenario (6 nodes, a standby that
    pre-warms, 30 pods arriving while it stands by, then promote) on both
    packages over the in-process API server: one pre-warm each, the
    promotion's adoption pass counts the same outcomes, and every pod is
    bound."""
    from kubernetes_tpu.api import objects as ref_v1
    from kubernetes_tpu.utils.metrics import metrics as ref_metrics

    metrics.reset()
    servers = (RefAPIServer(), APIServer())
    for o, srv in zip((ref_v1, v1), servers):
        for i in range(6):
            srv.create(
                "nodes",
                o.Node(
                    metadata=o.ObjectMeta(name=f"ha-{i}", namespace=""),
                    status=o.NodeStatus(
                        allocatable={"cpu": "8", "memory": "32Gi", "pods": 110}
                    ),
                ),
            )
    common = dict(antientropy_period_s=0, use_mesh=False)
    ref = ref_sched_mod.Scheduler(servers[0], RefConfig(**common))
    port = Scheduler(servers[1], KubeSchedulerConfiguration(**common), device="cpu")
    outcomes = ("bound", "pending", "gone")

    def adoptions(m):
        return [
            m.counter("scheduler_ha_adoptions_total", {"outcome": o})
            for o in outcomes
        ]

    ref0, w0 = adoptions(ref_metrics), ref_metrics.counter(
        "scheduler_ha_standby_warmups_total"
    )
    try:
        for s in (ref, port):
            s.start_standby(identity="warmup")
        assert ref_metrics.counter("scheduler_ha_standby_warmups_total") == w0 + 1
        assert metrics.counter("scheduler_ha_standby_warmups_total") == 1
        assert port._standby_thread is not None
        for o, srv in zip((ref_v1, v1), servers):
            for i in range(30):
                srv.create(
                    "pods",
                    o.Pod(
                        metadata=o.ObjectMeta(name=f"wu-{i}"),
                        spec=o.PodSpec(
                            containers=[o.Container(requests={"cpu": "100m"})]
                        ),
                    ),
                )
        for s in (ref, port):
            _wait(lambda s=s: len(s.queue) == 30, 30, "the standby to queue 30 pods")
            s.promote()
        assert port._standby_thread is None
        assert metrics.counter("scheduler_ha_promotions_total") == 1
        got = adoptions(metrics)
        assert got == [a - b for a, b in zip(adoptions(ref_metrics), ref0)]
        assert got == [0, 30, 0]
        for srv in servers:
            _wait(lambda srv=srv: len(_bound(srv)) == 30, 60, "30 pods bound")
    finally:
        ref.stop()
        port.stop()
