"""The what-if overlay and the what-if pass of the port against the reference
(both on the CPU, the port at device="cpu").

(a) ``SnapshotEncoder.whatif_overlay`` on both encoders of one cluster
    (build_cluster of tests/test_torch_encoding.py, fed to a reference and
    a port ``SchedulerCache``): K virtual nodes of mixed shapes — cost,
    accelerator and energy labels or none, a taint, new label keys — plus
    masked rows. Every field of the overlay equals the reference's
    exactly (values, shape, dtype), the assigned rows are equal, and both
    return None in the same no-room case. Both bases are covered: the
    pinned live generation, and a fresh upload when host updates are
    pending (a virtual node whose labels grow ``k_cap``).
(b) Isolation: the live generation is the same object and bit-identical
    after an overlay and after a pass, and no overlay tensor shares
    storage with it (``untyped_storage().data_ptr()``).
(c) ``WhatIfSimulator.simulate`` with the reference's per-pass tie noise
    injected (``ReferenceNoise``: the key chain of ``PRNGKey(7)``): the
    serial kernel's result of every pass (chosen, feasible_count and
    resolvable exact; score within tests/test_torch_serial_lattice.py's
    tolerance) and ``SimResult.chosen``, ``fallback`` and ``virtual_rows``
    are equal. A chosen row may differ only inside a TIE_EPS near-tie,
    which ``assert_serial_parity`` shows; none has been seen. Covered:
    scale-up, a single-node drain, a multi-node ``mask_nodes`` drain, a
    pod that overflows the encoding, an unknown masked node, and
    ``cost_aware`` both ways.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.autoscaler import planner as ref_planner
from kubernetes_tpu.ops.encoding import EncodingConfig as RefEncodingConfig
from kubernetes_tpu.scheduler.cache.cache import SchedulerCache as RefCache
from kubernetes_tpu_torch.autoscaler import planner as port_planner
from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
from kubernetes_tpu_torch.scheduler.cache.cache import SchedulerCache

from test_torch_encoding import PACKAGES, assert_same_fields, build_cluster
from test_torch_serial_lattice import assert_serial_parity, reference_noise

REF, PORT = PACKAGES


class ReferenceNoise:
    """The reference WhatIfSimulator's tie noise, pass by pass: its key
    starts at PRNGKey(7) and each pass splits off ``sub``; pod i of the
    pass draws ``uniform(split(sub, P)[i], (N,))``."""

    def __init__(self, seed: int = 7):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, p: int, n: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(reference_noise(sub, p, n))


def port_cache(n_cap=None):
    cfg = None if n_cap is None else EncodingConfig(n_cap=n_cap)
    return SchedulerCache(encoder=SnapshotEncoder(cfg, device="cpu"))


def ref_cache(n_cap=None):
    cfg = None if n_cap is None else RefEncodingConfig(n_cap=n_cap)
    return RefCache(encoding_config=cfg)


def cluster_caches(num_nodes=24, num_prefill=16):
    """(ref cache, port cache) holding build_cluster's nodes and bound
    prefill pods."""
    out = []
    for pkg, cache in zip(PACKAGES, (ref_cache(), port_cache())):
        nodes, prefill, _ = build_cluster(pkg, num_nodes, num_prefill)
        for n in nodes:
            cache.add_node(n)
        for name, pod in prefill:
            pod.spec.node_name = name
            cache.add_pod(pod)
        out.append(cache)
    return tuple(out)


def pending_pods(pkg, n=16):
    return build_cluster(pkg, num_pending=n)[2]


def virtual_nodes(pkg, k=6, wide=False):
    """K candidate nodes of mixed shapes in package `pkg`'s objects."""
    o = importlib.import_module(f"{pkg}.api.objects")
    ng = importlib.import_module(f"{pkg}.autoscaler.nodegroups")
    shapes = [
        ng.machine_shape(cpu="4", memory="16Gi"),
        ng.machine_shape(cpu="8", memory="32Gi", cost_per_hour=1.6,
                         accelerator_class="tpu-v5e", energy_watts=300.0),
        ng.machine_shape(cpu="16", memory="64Gi", cost_per_hour=15.0,
                         accelerator_class="tpu-v5p", labels={"zone": "z9"}),
    ]
    out = []
    for i in range(k):
        node = shapes[i % len(shapes)](f"whatif.g{i % len(shapes)}.{i}")
        if i % 4 == 3:
            node.spec.taints = [o.Taint("dedicated", "infra", "NoSchedule")]
        if wide and i == 0:
            node.metadata.labels.update({f"wk{j}": f"wv{j}" for j in range(40)})
        out.append(node)
    return out


def live_tensors(enc):
    return [t.clone() for t in enc._device]


def assert_live_untouched(enc, live_obj, before):
    assert enc._device is live_obj, "the live generation was replaced"
    for name, b, now in zip(type(live_obj)._fields, before, live_obj):
        assert torch.equal(b, now), f"the overlay perturbed live field {name}"


def assert_no_shared_storage(overlay, live):
    ptrs = {t.untyped_storage().data_ptr() for t in live}
    for name, t in zip(type(overlay)._fields, overlay):
        assert t.untyped_storage().data_ptr() not in ptrs, (
            f"overlay field {name} shares storage with the live generation"
        )


def overlays(ref, port, k=6, mask=("node-2", "node-7"), wide=False):
    """Both overlays of one request, built the reference's way (under the
    cache lock, after a flush)."""
    out = []
    for pkg, cache in zip(PACKAGES, (ref, port)):
        enc = cache.encoder
        with cache.lock:
            rows = [enc.row_of(m) for m in mask]
            out.append(enc.whatif_overlay(virtual_nodes(pkg, k, wide), rows))
    return out


# -- (a) + (b) the overlay -----------------------------------------------------


@pytest.mark.parametrize("k,mask", [(6, ("node-2", "node-7")), (0, ("node-4",)),
                                    (5, ()), (0, ())])
def test_overlay_matches_reference_and_leaves_live_untouched(k, mask):
    ref, port = cluster_caches()
    for cache in (ref, port):
        with cache.lock:
            cache.encoder.flush()
    live = port.encoder._device
    before = live_tensors(port.encoder)
    (ref_snap, ref_rows), (port_snap, port_rows) = overlays(ref, port, k, mask)
    assert port_rows == ref_rows
    assert port_rows == port.encoder.free_row_indices()[:k]
    assert_same_fields(ref_snap, port_snap, "overlay")
    assert_live_untouched(port.encoder, live, before)
    assert_no_shared_storage(port_snap, live)
    # the masked rows are live and valid outside the overlay
    for m in mask:
        r = port.encoder.row_of(m)
        assert bool(live.valid[r]) and not bool(port_snap.valid[r])


def test_overlay_from_masters_when_updates_are_pending():
    """A pod added since the last flush, and a virtual node whose 40 new
    label keys grow k_cap while it is interned: the base is a fresh upload
    of the masters on both sides (the live generation is neither read nor
    changed), and the overlay still matches field by field."""
    ref, port = cluster_caches()
    for cache in (ref, port):
        with cache.lock:
            cache.encoder.flush()
    for pkg, cache in zip(PACKAGES, (ref, port)):
        extra = build_cluster(pkg, num_prefill=20)[1][16:]
        for name, pod in extra:
            pod.spec.node_name = name
            cache.add_pod(pod)
    k_cap0 = port.encoder.cfg.k_cap
    live = port.encoder._device
    before = live_tensors(port.encoder)
    assert port.encoder.has_pending_updates
    (ref_snap, ref_rows), (port_snap, port_rows) = overlays(
        ref, port, k=4, wide=True
    )
    assert port.encoder.cfg.k_cap > k_cap0
    assert port_rows == ref_rows
    assert_same_fields(ref_snap, port_snap, "overlay")
    assert_live_untouched(port.encoder, live, before)
    assert_no_shared_storage(port_snap, live)


def test_overlay_before_the_first_flush_matches_reference():
    ref, port = cluster_caches()
    assert port.encoder._device is None
    (ref_snap, ref_rows), (port_snap, port_rows) = overlays(ref, port, k=3)
    assert port_rows == ref_rows
    assert_same_fields(ref_snap, port_snap, "overlay")


def test_overlay_refuses_when_no_free_rows_like_reference():
    """32 row capacity, 30 nodes: two virtual rows fit, three do not —
    None on both sides, and the live generation stays as it was."""
    caches = (ref_cache(n_cap=32), port_cache(n_cap=32))
    for pkg, cache in zip(PACKAGES, caches):
        nodes, _, _ = build_cluster(pkg, num_nodes=30, num_prefill=0)
        for n in nodes:
            cache.add_node(n)
        with cache.lock:
            cache.encoder.flush()
    ref, port = caches
    assert port.encoder.cfg.n_cap == ref.encoder.cfg.n_cap == 32
    live = port.encoder._device
    before = live_tensors(port.encoder)
    full = [
        c.encoder.whatif_overlay(virtual_nodes(pkg, 3)) for pkg, c in zip(PACKAGES, caches)
    ]
    assert full == [None, None]
    (ref_snap, ref_rows), (port_snap, port_rows) = overlays(ref, port, k=2, mask=())
    assert port_rows == ref_rows == [30, 31]
    assert_same_fields(ref_snap, port_snap, "overlay")
    assert_live_untouched(port.encoder, live, before)


# -- (c) the what-if pass -----------------------------------------------------


class _Recorder:
    """Records the serial kernel's BatchResult of every what-if pass of a
    planner module (its ``make_schedule_batch``)."""

    def __init__(self, module, monkeypatch, ref):
        self.results = []
        real = module.make_schedule_batch

        def make(*a, **kw):
            kern = real(*a, **kw)

            def run(*args):
                out = kern(*args)
                self.results.append(jax.device_get(out) if ref else out)
                return out

            return run

        monkeypatch.setattr(module, "make_schedule_batch", make)


def simulators(ref, port, monkeypatch, **kw):
    """(ref sim, port sim, ref recorder, port recorder); the port given
    the reference's tie noise."""
    rs = ref_planner.WhatIfSimulator(ref, **kw)
    ps = port_planner.WhatIfSimulator(port, noise=ReferenceNoise(), **kw)
    return (
        rs, ps,
        _Recorder(ref_planner, monkeypatch, True),
        _Recorder(port_planner, monkeypatch, False),
    )


def assert_sim_parity(ref_res, port_res, ref_rec, port_rec):
    """SimResults and the pass's kernel results equal; returns the pods
    whose chosen row differs (each a near-tie, shown by
    assert_serial_parity)."""
    assert (ref_res is None) == (port_res is None)
    if ref_res is None:
        return np.zeros(0, np.int64)
    assert len(port_rec.results) == len(ref_rec.results)
    diff = assert_serial_parity(ref_rec.results[-1], port_rec.results[-1])
    n = len(ref_res.chosen)
    diff = diff[diff < n]
    same = np.ones(n, bool)
    same[diff] = False
    assert port_res.chosen.dtype == ref_res.chosen.dtype
    np.testing.assert_array_equal(port_res.chosen[same], ref_res.chosen[same])
    np.testing.assert_array_equal(port_res.fallback, ref_res.fallback)
    assert port_res.virtual_rows == ref_res.virtual_rows
    return diff


def _residents(cache, names):
    out = []
    for name in names:
        for p in cache.get_node_info(name).pods:
            c = p.deep_copy()
            c.spec.node_name = ""
            out.append(c)
    return out


def _overflow_pod(pkg):
    o = importlib.import_module(f"{pkg}.api.objects")
    return o.Pod(
        metadata=o.ObjectMeta(name="overflow"),
        spec=o.PodSpec(
            containers=[o.Container(requests={"cpu": "100m"})],
            node_selector={f"k{j}": "v" for j in range(12)},
        ),
    )


@pytest.mark.parametrize("cost_aware", [True, False])
def test_simulate_scale_up_matches_reference(cost_aware, monkeypatch):
    ref, port = cluster_caches()
    rs, ps, rr, pr = simulators(ref, port, monkeypatch, max_pods_per_pass=64,
                                cost_aware=cost_aware)
    live = port.encoder._device
    ties = []
    for rnd in range(2):  # two passes: the noise key chain advances
        ref_pods, port_pods = (pending_pods(p, 24) for p in PACKAGES)
        ref_res = rs.simulate(ref_pods, virtual_nodes(REF, 9), kind="scale_up")
        port_res = ps.simulate(port_pods, virtual_nodes(PORT, 9), kind="scale_up")
        ties += assert_sim_parity(ref_res, port_res, rr, pr).tolist()
        assert (port_res.chosen >= 0).sum() >= 8
        # some pods went to virtual rows
        assert set(port_res.chosen.tolist()) & set(port_res.virtual_rows)
    assert ties == []
    assert port.encoder._device is live


@pytest.mark.parametrize("masked", [["node-3"], ["node-1", "node-6", "node-9"]],
                         ids=["single", "multi"])
def test_simulate_drain_pass_matches_reference(masked, monkeypatch):
    ref, port = cluster_caches()
    for cache in (ref, port):
        with cache.lock:
            cache.encoder.flush()
    live = port.encoder._device
    before = live_tensors(port.encoder)
    rs, ps, rr, pr = simulators(ref, port, monkeypatch, max_pods_per_pass=64)
    ref_res = rs.simulate(_residents(ref, masked), [], mask_nodes=masked, kind="defrag")
    port_res = ps.simulate(_residents(port, masked), [], mask_nodes=masked, kind="defrag")
    assert len(port_res.chosen) >= 1
    assert assert_sim_parity(ref_res, port_res, rr, pr).size == 0
    rows = {port.encoder.row_of(m) for m in masked}
    assert not rows & set(port_res.chosen.tolist())
    assert_live_untouched(port.encoder, live, before)
    # the drain verdicts of the copied planner agree as well
    verdicts = [
        mod.simulate_drain_set(s, masked, [p for n in masked for p in c.get_node_info(n).pods])
        for mod, s, c in ((ref_planner, rs, ref), (port_planner, ps, port))
    ]
    assert verdicts[1] == type(verdicts[1])(**verdicts[0].__dict__)


def test_simulate_overflow_pod_and_unknown_mask_match_reference(monkeypatch):
    ref, port = cluster_caches()
    rs, ps, rr, pr = simulators(ref, port, monkeypatch, max_pods_per_pass=64)
    ref_res = rs.simulate(
        pending_pods(REF, 6) + [_overflow_pod(REF)], virtual_nodes(REF, 3),
        mask_node="node-5",
    )
    port_res = ps.simulate(
        pending_pods(PORT, 6) + [_overflow_pod(PORT)], virtual_nodes(PORT, 3),
        mask_node="node-5",
    )
    assert assert_sim_parity(ref_res, port_res, rr, pr).size == 0
    assert port_res.fallback.tolist() == [False] * 6 + [True]
    assert rs.simulate(pending_pods(REF, 2), [], mask_node="nope") is None
    assert ps.simulate(pending_pods(PORT, 2), [], mask_node="nope") is None


def test_simulate_truncates_and_pads_like_reference(monkeypatch):
    """A pending set past max_pods_per_pass is cut to it; the pad bucket
    (64 here) is the reference's."""
    ref, port = cluster_caches()
    rs, ps, rr, pr = simulators(ref, port, monkeypatch, max_pods_per_pass=96)
    assert [ps._pad(n) for n in (1, 64, 65, 96, 500)] == [
        rs._pad(n) for n in (1, 64, 65, 96, 500)
    ]
    ref_res = rs.simulate(pending_pods(REF, 100), virtual_nodes(REF, 4))
    port_res = ps.simulate(pending_pods(PORT, 100), virtual_nodes(PORT, 4))
    assert len(port_res.chosen) == 96
    assert assert_sim_parity(ref_res, port_res, rr, pr).size == 0


def test_default_noise_is_a_seeded_device_generator():
    """Without injected noise a pass draws from a torch.Generator on the
    encoder's device seeded 7: two simulators over equal caches choose
    the same rows, and the pass counter and histogram move."""
    from kubernetes_tpu_torch.utils.metrics import metrics

    runs = []
    base = metrics.counter("autoscaler_simulation_passes_total", {"kind": "scale_up"})
    for _ in range(2):
        _, port = cluster_caches()
        sim = port_planner.WhatIfSimulator(port, max_pods_per_pass=64)
        assert sim._rng.device == port.encoder.device
        runs.append(sim.simulate(pending_pods(PORT, 12), virtual_nodes(PORT, 3)))
    np.testing.assert_array_equal(runs[0].chosen, runs[1].chosen)
    assert metrics.counter(
        "autoscaler_simulation_passes_total", {"kind": "scale_up"}
    ) == base + 2
    assert metrics.histogram("autoscaler_simulation_duration_seconds")
