"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit's ``nvcc`` and nothing else of
the network or the JAX package. Phases (any failure exits non-zero):

1. K1, the hand-written resource-fit kernel (csrc/fit_mask.cu, built here
   with nvcc into build/kernels/), against its plain PyTorch version on
   the card: the main-path shape [TPL, 8192, 6] for TPL = 8 and 64, ragged
   N (700, 5001), R = 1 and R = 12, zero-request columns and negative
   free. Tolerance: none, the masks must be bit-equal.
2. The main path: SchedulingPodAffinity/5000 (5,000 nodes, 1,000 initial
   pods, 5,000 measured pods with required zone pod-affinity; random
   choices from --seed) encoded on the card and scheduled batch by batch
   through scheduler/wavepath.py. Requires every pod placed, requested <=
   allocatable on every node, every placed pod in a zone that held an
   app=bench pod before its batch, the kernel-output guards passing on
   every batch, and K1 launched by the run.
3. One batch of the main path through the wave kernel twice, from the
   same snapshot clone and the same tie noise: with K1 and with the plain
   fit. Every WaveResult field and the returned snapshot must be equal.
4. The same batch through the wave kernel on the CPU (the path the tier-1
   tests hold against the JAX reference) against the card's run: exact
   masks, counts and snapshot; scores within rtol = 1e-5; chosen nodes
   equal except inside a TIE_EPS near-tie.

The last lines are the card's name and power limit (nvidia-smi), a
``{"kernels": [...]}`` JSON line with each kernel's launches on the main
path, time, bound and plain time, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core 32-bit rate (no tensor cores)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of fn() issued back to back from Python, between two
    CUDA events after warm-up: the device time plus whatever host launch
    overhead the device waits on."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time per call of fn(): `iters` calls captured in one CUDA
    graph, replayed `reps` times between two CUDA events, so host launch
    overhead drops out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def fit_case(seed, tpl, n, r, device):
    g = np.random.default_rng(seed)
    req = g.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[g.random((tpl, r)) < 0.3] = 0  # sparse requests
    req[:, 0] = np.where(np.arange(tpl) % 3 == 0, 0, req[:, 0])  # zero columns
    alloc = g.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * g.random((n, r)) * 0.9).astype(np.int32)
    free[::5] -= 70000  # over-committed nodes: negative free
    return (
        torch.tensor(req, device=device),
        torch.tensor(free, device=device),
    )


def fit_bound(tpl: int, n: int, r: int):
    """(bound_ms, bound_by) for one fit mask: each input read once, the
    mask written once, against TPL*N*R compares at the 32-bit rate."""
    bytes_ = n * r * 4 + tpl * n + tpl * r * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = tpl * n * r / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fit_kernel(device):
    from kubernetes_tpu_torch.ops import fit_kernels

    t0 = time.perf_counter()
    lib = fit_kernels.library()
    log(f"[K1] built/loaded {lib.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(R max {lib.r_max})")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[K1] ptxas: {line.strip()}")
    cases = [
        (8, 8192, 6), (64, 8192, 6), (4, 700, 6), (16, 5001, 6),
        (8, 8192, 1), (8, 5001, 12),
    ]
    for i, (tpl, n, r) in enumerate(cases):
        req, free = fit_case(i, tpl, n, r, device)
        got = fit_kernels.fit_mask(req, free)
        torch.cuda.synchronize()
        want = fit_kernels.fit_mask_plain(req, free)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"[K1] TPL={tpl} N={n} R={r}: {bad} mask entries differ")
        ms = device_ms(lambda: fit_kernels.fit_mask(req, free))
        plain = device_ms(lambda: fit_kernels.fit_mask_plain(req, free))
        bound, by = fit_bound(tpl, n, r)
        log(f"[K1] TPL={tpl} N={n} R={r}: bit-equal; device time kernel "
            f"{ms:.5f} ms, plain {plain:.5f} ms; bound {bound:.6f} ms ({by})")
    log("[K1] no single PyTorch call computes this mask: library_ms is null")


def main_path(device, seed: int, name: str = "SchedulingPodAffinity/5000", cfg=None):
    """Encode the workload's nodes on `device`, schedule its initial then
    its measured pods through the wave path, check the result. Returns a
    dict of what the caller reports."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.ops.lattice import weights_for_policy
    from kubernetes_tpu_torch.ops.templates import TemplateCache
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler.wavepath import WavePathConfig, schedule_pods

    cfg = cfg or WavePathConfig()
    wl = WORKLOADS[name]
    nodes, init_pods, factory = build_workload(wl)
    measured = [factory(i) for i in range(wl.num_measured_pods)]
    t0 = time.perf_counter()
    enc = SnapshotEncoder(EncodingConfig.for_cluster(wl.num_nodes), device=device)
    for n in nodes:
        enc.add_node(n)
    enc.flush()
    setup_s = time.perf_counter() - t0
    cache = TemplateCache(enc)
    weights = torch.tensor(weights_for_policy("default"), device=device)
    rng = torch.Generator(device=device).manual_seed(seed)

    init = schedule_pods(enc, cache, init_pods, weights, rng, cfg)
    if init.unscheduled or init.fallback or len(init.placed) != len(init_pods):
        raise AssertionError(f"init pods: {len(init.placed)}/{len(init_pods)} placed")
    zone_of = {n.metadata.name: n.metadata.labels["topology.kubernetes.io/zone"] for n in nodes}
    bench_zones = {zone_of[node] for _pod, node in init.placed}

    fit_kernels.fit_mask.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schedule_pods(enc, cache, measured, weights, rng, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fit_kernels.fit_mask.launches

    placed = len(res.placed)
    if placed != len(measured) or res.unscheduled or res.fallback:
        raise AssertionError(
            f"{placed}/{len(measured)} placed, {len(res.unscheduled)} unscheduled, "
            f"{len(res.fallback)} fallback"
        )
    valid = enc.m_valid
    if not (enc.m_req <= enc.m_alloc)[valid].all():
        raise AssertionError("requested exceeds allocatable on some node")
    i = 0
    for bo in res.batches:
        zones = {zone_of[node] for _pod, node in bo.placed}
        if not zones <= bench_zones:
            raise AssertionError(
                f"batch {i}: pods placed in zones {sorted(zones - bench_zones)} "
                "that held no app=bench pod (required affinity)"
            )
        bench_zones |= zones
        i += 1
    return {
        "enc": enc, "cache": cache, "weights": weights, "rng": rng, "cfg": cfg,
        "factory": factory, "placed": placed, "wall_s": wall, "setup_s": setup_s,
        "batches": res.batches, "launches": launches,
    }


def compare_results(a_snap, a_res, b_snap, b_res, tie_ok: bool, what: str):
    """Exact equality of masks, counts and snapshot; with tie_ok, chosen
    may differ inside a TIE_EPS near-tie (scores within rtol 1e-5)."""
    from kubernetes_tpu_torch.ops.wavelattice import TIE_EPS

    def np_(x):
        return x.cpu().numpy()

    for f in ("placed", "deferred", "feasible_count", "feasible_tpl", "resolvable_tpl"):
        if not np.array_equal(np_(getattr(a_res, f)), np_(getattr(b_res, f))):
            raise AssertionError(f"{what}: WaveResult.{f} differs")
    ca, cb = np_(a_res.chosen), np_(b_res.chosen)
    sa, sb = np_(a_res.score), np_(b_res.score)
    diff = np.flatnonzero(ca != cb)
    if diff.size and not tie_ok:
        raise AssertionError(f"{what}: chosen differs for {diff.size} pods")
    for i in diff:
        if abs(float(sa[i]) - float(sb[i])) > TIE_EPS * max(1.0, abs(float(sa[i]))):
            raise AssertionError(f"{what}: pod {i} chose {ca[i]} vs {cb[i]} outside a tie")
    same = ca == cb
    if tie_ok:
        if not np.allclose(sa[same], sb[same], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: scores differ beyond rtol 1e-5")
    elif not np.array_equal(sa, sb):
        raise AssertionError(f"{what}: scores differ")
    if diff.size == 0:
        for f in a_snap._fields:
            x, y = np_(getattr(a_snap, f)), np_(getattr(b_snap, f))
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: snapshot.{f} differs")
    return int(diff.size)


def phase_parity(mp, device):
    """Phases 3 and 4 on one fresh batch of the main path's workload."""
    from kubernetes_tpu_torch.ops.templates import TemplateBatch
    from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel
    from kubernetes_tpu_torch.scheduler.wavepath import prepare_batch

    enc, cfg = mp["enc"], mp["cfg"]
    pods = [mp["factory"](100000 + i) for i in range(cfg.batch_size)]
    prep = prepare_batch(enc, mp["cache"], pods, cfg)
    snap = enc.flush()
    k = prep.kern
    args = (k.v_cap, k.m_cand, k.n_waves, k.hard_pod_affinity_weight)
    rest = (k.score_refresh, k.rtc_shape, k.has_pinned)
    kern_fit = make_wave_kernel(*args, True, *rest)
    kern_plain = make_wave_kernel(*args, False, *rest)
    m_c = min(k.m_cand, snap.valid.shape[0])
    noise = torch.rand(
        (cfg.batch_size, m_c), generator=mp["rng"], device=device
    ) * 0.999

    def clone(nt):
        return type(nt)(*(t.clone() for t in nt))

    s_fit, r_fit = kern_fit.with_noise(clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise)
    s_plain, r_plain = kern_plain.with_noise(clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise)
    compare_results(s_fit, r_fit, s_plain, r_plain, False, "K1 vs plain fit in the wave kernel")
    log(f"[wave] K1 fit == plain fit on one main-path batch: every WaveResult field "
        f"and the snapshot equal ({int(r_fit.placed.sum())} of {len(pods)} placed)")

    def cpu(nt):
        if isinstance(nt, TemplateBatch):
            return TemplateBatch(cpu(nt.tpl), *(t.cpu() for t in nt[1:]))
        return type(nt)(*(t.cpu() for t in nt))

    t0 = time.perf_counter()
    s_cpu, r_cpu = kern_fit.with_noise(
        cpu(snap), cpu(prep.eb.batch), cpu(prep.ptab), mp["weights"].cpu(), noise.cpu()
    )
    cpu_s = time.perf_counter() - t0
    ties = compare_results(s_cpu, r_cpu, s_fit, r_fit, True, "CPU vs card wave kernel")
    log(f"[wave] CPU run of the same batch ({cpu_s:.2f} s) agrees with the card "
        f"({ties} near-tie chosen differences)")
    try:
        profile_wave(kern_fit, clone(snap), prep, mp["weights"], noise)
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] wave kernel device time not measured: {e}")


def profile_wave(kern, snap, prep, weights, noise) -> None:
    """Where one wave-kernel launch spends its time on this batch: wall
    time against the sum of device kernel time (torch.profiler), and the
    kernels that take most of it. Measurement only: prints "not measured"
    when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern.with_noise(snap, prep.eb.batch, prep.ptab, weights, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[profile] wave kernel, one batch: wall {wall_ms:.2f} ms; device time "
            "not measured (the profiler saw no device activity)")
        return
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] wave kernel, one batch of {prep.eb.batch.pod_tpl.shape[0]} pods, "
        f"{prep.n_waves} waves: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms in {launches} kernel launches "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f})")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    from kubernetes_tpu_torch.ops import fit_kernels

    phase_fit_kernel(device)

    mp = main_path(device, args.seed)
    b = mp["batches"]
    enc_s = sum(x.encode_s for x in b)
    ker_s = sum(x.kernel_s for x in b)
    com_s = sum(x.commit_s for x in b)
    log(f"[main] SchedulingPodAffinity/5000: {mp['placed']}/5000 placed in "
        f"{mp['wall_s']:.3f} s = {mp['placed'] / mp['wall_s']:.1f} pods/s; "
        f"{len(b)} batches, waves {[x.n_waves for x in b]}, placed per batch "
        f"{[len(x.placed) for x in b]}; encode {enc_s:.3f} s, "
        f"kernel {ker_s:.3f} s, commit {com_s:.3f} s; node setup {mp['setup_s']:.2f} s; "
        f"K1 launches {mp['launches']}; card {card}")
    if mp["launches"] <= 0:
        raise AssertionError("the main path never launched K1")

    # K1 timed on the main path's own inputs: its template requests and
    # the live snapshot's free matrix
    enc = mp["enc"]
    snap = enc.flush()
    req = mp["cache"]._tpl_batch.req.contiguous()
    free = (snap.allocatable - snap.requested).contiguous()
    tpl, r = req.shape
    n = free.shape[0]
    got = fit_kernels.fit_mask(req, free)
    max_abs_err = float((got.int() - fit_kernels.fit_mask_plain(req, free).int()).abs().max())
    ms = device_ms(lambda: fit_kernels.fit_mask(req, free))
    plain_ms = device_ms(lambda: fit_kernels.fit_mask_plain(req, free))
    call = call_ms(lambda: fit_kernels.fit_mask(req, free))
    plain_call = call_ms(lambda: fit_kernels.fit_mask_plain(req, free))
    bound_ms, bound_by = fit_bound(tpl, n, r)
    log(f"[K1] main-path shape TPL={tpl} N={n} R={r}: device time kernel "
        f"{ms:.5f} ms, plain {plain_ms:.5f} ms; per call from Python kernel "
        f"{call:.5f} ms, plain {plain_call:.5f} ms; bound {bound_ms:.6f} ms "
        f"({bound_by}); max |kernel - plain| {max_abs_err}")

    phase_parity(mp, device)

    kernels = {
        "kernels": [
            {
                "name": "fit_mask",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_mask.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:120",
                "launches": mp["launches"],
                "max_abs_err": max_abs_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        ]
    }
    log(f"card: {card}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
