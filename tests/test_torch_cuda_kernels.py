"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the torch device programs (the serial lattice, the victim
selection) on the card against their own CPU run. Every test here is
marked ``cuda`` and skips without a CUDA device (the kernels have no CPU
or interpret mode; the plain versions and the CPU runs are held against
the JAX reference in the CPU tests).

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerance: none — the fit mask is boolean and must be bit-equal, and
K2's score is built to match its plain version bit for bit (explicit
round-to-nearest steps, -fmad=false). The serial lattice and the victim
selection must give the same outputs on the card as on the CPU, every
field equal: their float work is single IEEE operations and sums of
integer-valued terms.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops.fit_kernels import (
    fit_mask,
    fit_mask_least_alloc,
    fit_mask_least_alloc_plain,
    fit_mask_plain,
)


def _case(seed, tpl, n, r):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[rng.random((tpl, r)) < 0.3] = 0  # zero requests fit anywhere
    alloc = rng.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * rng.random((n, r)) * 0.9).astype(np.int32)
    free[::7] -= 70000  # negative free
    return torch.from_numpy(req).cuda(), torch.from_numpy(free).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tpl,n,r",
    [(4, 8192, 6), (8, 8192, 6), (64, 8192, 6), (5, 700, 6), (3, 5001, 1),
     (7, 1000, 12), (300, 129, 6), (1, 1, 16),
     # the tiling's edges: N % 4 = 1, 2, 3 (a partial last block); N < 4;
     # TPL off the 4-template tile; TPL > 256 over many tiles; empty
     (4, 8193, 6), (5, 8194, 6), (17, 8195, 6), (3, 2, 6), (2, 3, 7),
     (257, 4099, 6), (33, 0, 6), (0, 64, 6),
     # one shard's rows of the main path's 8192 over a mesh of 4 and 8
     (4, 2048, 6), (4, 1024, 6)],
)
def test_fit_mask_kernel_matches_plain(tpl, n, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free = _case(tpl * 1000 + n + r, tpl, n, r)
    before = fit_mask.launches
    got = fit_mask(req, free)
    torch.cuda.synchronize()
    assert fit_mask.launches == before + (1 if tpl and n else 0)
    assert got.dtype == torch.bool and got.shape == (tpl, n)
    assert torch.equal(got, fit_mask_plain(req, free))


@pytest.mark.cuda
def test_fit_mask_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free = _case(0, 4, 256, 6)
    with pytest.raises(TypeError):
        fit_mask(req.long(), free)
    with pytest.raises(ValueError):
        fit_mask(req, free.cpu())
    with pytest.raises(ValueError):
        fit_mask(req[:, :5], free)
    with pytest.raises(ValueError):
        fit_mask(*_case(1, 2, 64, 17))


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts 8 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    view = buf[2:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    return view


@pytest.mark.cuda
def test_fit_mask_kernel_takes_a_misaligned_view():
    """K1 reads its [N, R] rows as scalar words: a contiguous view that
    starts 8 bytes past a 16-byte boundary is launched and bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free = _case(2, 4, 8192, 6)
    view = _misaligned(free)
    before = fit_mask.launches
    got = fit_mask(req, view)
    torch.cuda.synchronize()
    assert fit_mask.launches == before + 1
    assert torch.equal(got, fit_mask_plain(req, free))


@pytest.mark.cuda
def test_fit_mask_least_alloc_refuses_a_misaligned_view_and_launches_nothing():
    """K2 reads its [N, R] node tiles as int4 vectors: a free or alloc view
    that does not start on 16 bytes raises with a message, and nothing is
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free, alloc = _la_case(3, 4, 256, 6)
    before = fit_mask_least_alloc.launches
    with pytest.raises(ValueError, match="16-byte"):
        fit_mask_least_alloc(req, _misaligned(free), alloc)
    with pytest.raises(ValueError, match="16-byte"):
        fit_mask_least_alloc(req, free, _misaligned(alloc))
    assert fit_mask_least_alloc.launches == before


def _la_case(seed, tpl, n, r):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[rng.random((tpl, r)) < 0.3] = 0  # sparse requests
    req[0] = 0  # a zero-request template
    alloc = rng.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * rng.random((n, r)) * 0.9).astype(np.int32)
    free[::7] -= 70000  # negative free
    alloc[::11, 0] = 0  # alloc = 0: the denominator clamps to 1
    if n > 3 and tpl > 1:
        free[3, :] = req[1]  # an exact fit for template 1
    return tuple(torch.from_numpy(x).cuda() for x in (req, free, alloc))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tpl,n,r",
    [(16, 8192, 6), (16, 700, 6), (16, 5001, 6), (4, 8192, 1), (8, 5001, 12),
     (300, 129, 6), (2, 1, 16),
     # the tiling's edges: TPL off the 4-template tile; N % 4 = 3, 1, 2
     # (a ragged node tile takes scalar loads); N < 4; TPL > 256
     (17, 8191, 6), (5, 4097, 6), (3, 1030, 6), (6, 3, 6), (257, 2049, 6)],
)
def test_fit_mask_least_alloc_kernel_matches_plain(tpl, n, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free, alloc = _la_case(tpl * 1000 + n + r, tpl, n, r)
    before = fit_mask_least_alloc.launches
    mask, score = fit_mask_least_alloc(req, free, alloc)
    torch.cuda.synchronize()
    assert fit_mask_least_alloc.launches == before + 1
    assert mask.dtype == torch.bool and mask.shape == (tpl, n)
    assert score.dtype == torch.float32 and score.shape == (tpl, n)
    pm, ps = fit_mask_least_alloc_plain(req, free, alloc)
    assert torch.equal(mask, pm)
    assert torch.equal(mask, fit_mask_plain(req, free))
    assert torch.equal(score, ps), float((score - ps).abs().max())


@pytest.mark.cuda
def test_fit_mask_least_alloc_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free, alloc = _la_case(0, 4, 256, 6)
    with pytest.raises(TypeError):
        fit_mask_least_alloc(req, free, alloc.long())
    with pytest.raises(ValueError):
        fit_mask_least_alloc(req, free, alloc.cpu())
    with pytest.raises(ValueError):
        fit_mask_least_alloc(req, free, alloc[:, :5].contiguous())
    with pytest.raises(ValueError):
        fit_mask_least_alloc(*_la_case(1, 2, 64, 17))


def _to(nt, device):
    return type(nt)(*(t.to(device) for t in nt))


def _seeded_cluster(seed, n_nodes=64, n_pending=48, per_node=2):
    """(encoder on the CPU, pending pods): zoned nodes with taints and
    priority-banded prefill pods, some carrying required anti-affinity;
    pending pods with required zone affinity and anti-affinity, topology
    spread, tolerations and priorities, drawn from a numpy seed."""
    from kubernetes_tpu_torch.api import objects as o
    from kubernetes_tpu_torch.api.selectors import LabelSelector
    from kubernetes_tpu_torch.ops.encoding import SnapshotEncoder

    rng = np.random.default_rng(seed)
    enc = SnapshotEncoder(device="cpu")

    def term(app):
        return o.PodAffinityTerm(
            label_selector=LabelSelector.make(match_labels={"app": app}),
            topology_key="zone",
        )

    for i in range(n_nodes):
        taints = [o.Taint("dedicated", "infra", "NoSchedule")] if i % 9 == 0 else []
        enc.add_node(
            o.Node(
                metadata=o.ObjectMeta(
                    name=f"n{i}", namespace="", labels={"zone": f"z{i % 4}"}
                ),
                spec=o.NodeSpec(taints=taints),
                status=o.NodeStatus(
                    allocatable={"cpu": "4", "memory": "16Gi", "pods": 32}
                ),
            )
        )
    apps = ("web", "db", "cache")
    for j in range(per_node * n_nodes):
        app = apps[int(rng.integers(0, 3))]
        aff = (
            o.Affinity(pod_anti_affinity=o.PodAntiAffinity(required=(term("db"),)))
            if app == "cache" and rng.random() < 0.3
            else None
        )
        enc.add_pod(
            f"n{int(rng.integers(0, n_nodes))}",
            o.Pod(
                metadata=o.ObjectMeta(name=f"pre-{j}", labels={"app": app}),
                spec=o.PodSpec(
                    containers=[o.Container(requests={"cpu": "500m"})],
                    priority=int(rng.choice([0, 10, 100])),
                    affinity=aff,
                ),
            ),
        )
    pending = []
    for k in range(n_pending):
        app = apps[int(rng.integers(0, 3))]
        kw = {}
        roll = rng.random()
        if roll < 0.25:
            kw["affinity"] = o.Affinity(pod_affinity=o.PodAffinity(required=(term("web"),)))
        elif roll < 0.5:
            kw["affinity"] = o.Affinity(
                pod_anti_affinity=o.PodAntiAffinity(required=(term(app),))
            )
        elif roll < 0.7:
            kw["topology_spread_constraints"] = [
                o.TopologySpreadConstraint(
                    max_skew=1, topology_key="zone",
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector.make(match_labels={"app": app}),
                )
            ]
        if rng.random() < 0.3:
            kw["tolerations"] = [o.Toleration(key="dedicated", operator="Exists")]
        pending.append(
            o.Pod(
                metadata=o.ObjectMeta(name=f"p{k}", labels={"app": app}),
                spec=o.PodSpec(
                    containers=[o.Container(
                        requests={"cpu": str(int(rng.choice([1, 2, 3])))}
                    )],
                    priority=int(rng.choice([20, 200])),
                    **kw,
                ),
            )
        )
    return enc, pending


@pytest.mark.cuda
def test_serial_lattice_on_the_card_matches_its_cpu_run():
    """The serial kernel on the card and on the CPU, from one seeded
    cluster's snapshot and one tie noise: every BatchResult field equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.lattice import (
        BatchResult,
        make_schedule_batch,
        weights_for_policy,
    )

    enc, pods = _seeded_cluster(0)
    eb = encode_pod_batch(enc, pods, pad_to=64)
    snap = enc.flush()
    noise = torch.rand((64, snap.valid.shape[0]), generator=torch.Generator().manual_seed(0))
    weights = torch.tensor(weights_for_policy("default"))
    kern = make_schedule_batch(enc.cfg.v_cap)
    want = kern(snap, eb.batch, weights, noise)
    got = kern(_to(snap, "cuda"), _to(eb.batch, "cuda"), weights.cuda(), noise.cuda())
    for f in BatchResult._fields:
        g = getattr(got, f)
        assert g.is_cuda and torch.equal(g.cpu(), getattr(want, f)), f
    assert int((want.chosen >= 0).sum()) >= 16 and int((want.chosen < 0).sum()) >= 1


@pytest.mark.cuda
def test_preempt_select_on_the_card_matches_its_cpu_run():
    """The victim selection on the card and on the CPU for one seeded
    banded cluster: all six outputs equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.preemptlattice import (
        PreemptBatchResult,
        preempt_select,
    )

    enc, pods = _seeded_cluster(1, n_nodes=32, n_pending=16, per_node=7)
    eb = encode_pod_batch(enc, pods, pad_to=16)
    snap = enc.flush()
    want = preempt_select(snap, eb.batch, eb.batch.priority)
    got = preempt_select(_to(snap, "cuda"), _to(eb.batch, "cuda"), eb.batch.priority.cuda())
    for f in PreemptBatchResult._fields:
        g = getattr(got, f)
        assert g.is_cuda and torch.equal(g.cpu(), getattr(want, f)), f
    assert len(set(want.node.tolist()) - {-1}) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_wave_and_serial_kernels_on_the_card_match_one_device(shards):
    """The node-sharded kernels over virtual entries of the card: every
    output and the committed snapshot equal the single-device kernels' on
    the card, and the wave kernel launches K1 once per shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.encoding import gather_snapshot
    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch, weights_for_policy
    from kubernetes_tpu_torch.ops.templates import TemplateCache, build_pair_table
    from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel
    from kubernetes_tpu_torch.parallel import make_mesh, shard_snapshot
    from kubernetes_tpu_torch.parallel.mesh import virtual_devices
    from kubernetes_tpu_torch.parallel.sharded import (
        make_sharded_schedule_batch,
        make_sharded_wave_kernel,
    )

    dev = "cuda"
    enc, pods = _seeded_cluster(2)
    eb = TemplateCache(enc).encode(pods, pad_to=64)
    pt, _ = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    batch = encode_pod_batch(enc, pods[:16], pad_to=16).batch
    snap = _to(enc.flush(), dev)  # after the encodes: they may intern
    tb = type(eb.batch)(_to(eb.batch.tpl, dev), *(t.to(dev) for t in eb.batch[1:]))
    pt, batch = _to(pt, dev), _to(batch, dev)
    mesh = make_mesh(virtual_devices(dev, shards))
    weights = torch.tensor(weights_for_policy("default")).to(dev)
    n = snap.valid.shape[0]
    noise = (torch.rand((64, min(32, n)), generator=torch.Generator().manual_seed(1)) * 0.999).to(dev)
    # the wave kernel commits in place: the single-device run takes a clone
    one = type(snap)(*(t.clone() for t in snap))
    s1, r1 = make_wave_kernel(enc.cfg.v_cap, 32, 4).with_noise(one, tb, pt, weights, noise)
    before = fit_mask.launches
    s2, r2 = make_sharded_wave_kernel(enc.cfg.v_cap, 32, 4, 1.0, mesh).with_noise(
        shard_snapshot(snap, mesh), tb, pt, weights, noise
    )
    assert fit_mask.launches == before + (shards if dev == "cuda" else 0)
    for f in ("chosen", "placed", "deferred", "feasible_count", "score"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert int(r1.placed.sum()) >= 16
    g = gather_snapshot(s2)
    for f in s1._fields:
        assert torch.equal(getattr(s1, f), getattr(g, f)), f
    noise = torch.rand((16, n), generator=torch.Generator().manual_seed(2)).to(dev)
    a = make_schedule_batch(enc.cfg.v_cap)(snap, batch, weights, noise)
    b = make_sharded_schedule_batch(enc.cfg.v_cap, mesh)(shard_snapshot(snap, mesh), batch, weights, noise)
    for f in ("chosen", "score", "feasible_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.resolvable.cpu(), b.resolvable.cpu())


# -- the data-plane defense on the card ------------------------------------


@pytest.mark.cuda
def test_device_probe_answers_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.parallel.mesh import _default_probe
    from kubernetes_tpu_torch.scheduler import Scheduler

    assert _default_probe(torch.device("cuda", 0))
    assert _default_probe(None)
    assert Scheduler._device_probe(torch.device("cuda", 0))


def _cudart():
    """The CUDA runtime library the card's toolkit ships, for its own
    error strings."""
    import ctypes
    import ctypes.util
    import glob

    names = [ctypes.util.find_library("cudart")] + sorted(
        glob.glob("/usr/local/cuda/lib64/libcudart.so*")
    )
    for name in names:
        if name:
            try:
                return ctypes.CDLL(name)
            except OSError:
                continue
    raise AssertionError("libcudart not found")


@pytest.mark.cuda
def test_device_loss_markers_are_the_cuda_runtime_strings():
    """Each CUDA marker of parallel/sharded.py is the runtime's own
    cudaGetErrorString text or enum name of a device-gone error, and the
    runtime's texts of program faults are not classified as device loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes

    from kubernetes_tpu_torch.parallel.sharded import (
        _DEVICE_LOSS_MARKERS,
        is_device_loss_error,
    )

    rt = _cudart()
    rt.cudaGetErrorString.restype = ctypes.c_char_p
    rt.cudaGetErrorName.restype = ctypes.c_char_p

    def text(code):
        return rt.cudaGetErrorString(code).decode(), rt.cudaGetErrorName(code).decode()

    # cudaErrorNoDevice, cudaErrorDevicesUnavailable,
    # cudaErrorECCUncorrectable, cudaErrorLaunchTimeout
    for code in (100, 46, 214, 702):
        msg, name = text(code)
        assert any(m in msg.lower() for m in _DEVICE_LOSS_MARKERS), (code, msg)
        assert name.lower() in _DEVICE_LOSS_MARKERS, (code, name)
        assert is_device_loss_error(RuntimeError(f"CUDA error: {msg}"))
    # illegal address, device-side assert, invalid configuration, out of
    # memory, misaligned address, illegal instruction, launch failure
    for code in (700, 710, 9, 2, 716, 715, 719):
        msg, name = text(code)
        assert not is_device_loss_error(RuntimeError(f"CUDA error: {msg}")), (code, msg)
        assert not is_device_loss_error(RuntimeError(name)), (code, name)


def _audit_cluster(device):
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload

    nodes, init, _ = build_workload(
        WorkloadConfig("SchedulingPodAffinity", 500, 400, 1)
    )
    enc = SnapshotEncoder(EncodingConfig.for_cluster(500), device=device)
    for n in nodes:
        enc.add_node(n)
    for i, p in enumerate(init):
        enc.add_pod(f"node-{(7 * i) % 500}", p)
    enc.flush()
    return enc


@pytest.mark.cuda
def test_corrupt_audit_repair_on_the_card_matches_the_cpu():
    """The same corruption of two fields on a 500-node snapshot on the card
    and on the CPU: one audit pass gives the same report on both (exactly
    the corrupted rows, no master repair, no rebuild), and afterwards every
    row-major field on the card equals the host masters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.scheduler.antientropy import SnapshotAntiEntropy
    from kubernetes_tpu_torch.testing.device_faults import corrupt_device_rows

    reports = []
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        enc = _audit_cluster(device)
        rows = [3, 17, 40, 41]
        corrupt_device_rows(enc, rows, field="requested")
        corrupt_device_rows(enc, rows[:2], field="valid")
        corrupt_device_rows(enc, [5], field="eterm_w", mutate=lambda a: a + 0.5)
        rep = SnapshotAntiEntropy(enc, sample_rows=64).audit_once()
        reports.append((
            rep["rows_audited"], rep["device_drift"], rep["master_repaired"],
            rep["rebuilt"],
        ))
        for field in enc.ROW_FIELDS:
            np.testing.assert_array_equal(
                getattr(enc._device, field).cpu().numpy(), enc._master_of(field),
                err_msg=field,
            )
    assert reports[0] == reports[1]
    assert reports[0][1] == {
        "requested": [3, 17, 40, 41], "valid": [3, 17], "eterm_w": [5],
    }
    assert not reports[0][2] and not reports[0][3]


@pytest.mark.cuda
def test_fetch_device_rows_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = _audit_cluster(torch.device("cuda", 0))
    cpu = _audit_cluster(torch.device("cpu"))
    rows = list(range(0, 500, 7))
    a, b = card.fetch_device_rows(rows), cpu.fetch_device_rows(rows)
    assert list(a) == list(b)
    for field in a:
        assert a[field].dtype == b[field].dtype
        np.testing.assert_array_equal(a[field], b[field], err_msg=field)


def _whatif_request():
    from kubernetes_tpu_torch.api import objects as o
    from kubernetes_tpu_torch.perf.workloads import (
        WorkloadConfig,
        autoscaler_candidate_shapes,
        build_workload,
    )

    virtual = [
        g.make_node(f"whatif.{g.name}.{i}")
        for g in autoscaler_candidate_shapes() for i in range(4)
    ]
    _n, _i, factory = build_workload(WorkloadConfig("SchedulingPodAffinity", 500, 400, 1))
    pods = [factory(i) for i in range(56)] + [
        o.Pod(
            metadata=o.ObjectMeta(name=f"big-{i}"),
            spec=o.PodSpec(containers=[o.Container(requests={"cpu": "12"})]),
        )
        for i in range(8)
    ]
    return virtual, ["node-3", "node-250", "node-499"], pods


@pytest.mark.cuda
def test_whatif_overlay_and_pass_on_the_card_match_the_cpu():
    """The what-if overlay (16 virtual nodes, 3 masked rows) of a 500-node
    snapshot on the card and on the CPU: every field equal, the card's
    live generation bit-identical afterwards and sharing no storage with
    the overlay; then one 64-pod what-if pass on both with the same tie
    noise: chosen, fallback and the virtual rows equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubernetes_tpu_torch.autoscaler import WhatIfSimulator
    from kubernetes_tpu_torch.scheduler.cache.cache import SchedulerCache

    virtual, masked, pods = _whatif_request()
    caches = [
        SchedulerCache(encoder=_audit_cluster(d))
        for d in (torch.device("cuda", 0), torch.device("cpu"))
    ]
    card = caches[0].encoder
    live = card._device
    before = [t.clone() for t in live]
    rows = [card.row_of(m) for m in masked]
    (snap, vrows), (cpu_snap, cpu_rows) = (
        c.encoder.whatif_overlay(virtual, rows) for c in caches
    )
    assert vrows == cpu_rows and len(vrows) == len(virtual)
    for f in snap._fields:
        assert getattr(snap, f).is_cuda, f
        assert torch.equal(getattr(snap, f).cpu(), getattr(cpu_snap, f)), f
    assert card._device is live
    assert all(torch.equal(b, t) for b, t in zip(before, live))
    ptrs = {t.untyped_storage().data_ptr() for t in live}
    assert not any(t.untyped_storage().data_ptr() in ptrs for t in snap)

    def noise():
        gen = torch.Generator().manual_seed(3)
        return lambda p, n: torch.rand((p, n), generator=gen)

    sims = [
        WhatIfSimulator(c, noise=lambda p, n, d=c.encoder.device, f=noise(): f(p, n).to(d))
        for c in caches
    ]
    got, want = (s.simulate(pods, virtual, mask_nodes=masked) for s in sims)
    np.testing.assert_array_equal(got.chosen, want.chosen)
    np.testing.assert_array_equal(got.fallback, want.fallback)
    assert got.virtual_rows == want.virtual_rows
    assert set(got.chosen.tolist()) & set(got.virtual_rows)
    assert all(torch.equal(b, t) for b, t in zip(before, live))
