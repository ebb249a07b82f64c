"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit's ``nvcc`` and nothing else of
the network or the JAX package. Both kernels (csrc/fit_mask.cu and
csrc/fit_least_alloc.cu) are built first, by two nvcc processes started
together, into build/kernels/. Phases (any failure exits non-zero):

1. K1, the hand-written resource-fit kernel, against its plain PyTorch
   version on the card: the main-path shape [TPL, 8192, 6] for TPL = 8
   and 64, ragged N (700, 5001), R = 1 and R = 12, zero-request columns
   and negative free; and the edge shapes of its tiling: N % 4 = 1, 2, 3
   (8193-8195), N < 4, TPL off its 4-template tile, TPL > 256.
   Tolerance: none, the masks must be bit-equal. At [8, 8192, 6] and
   [64, 8192, 6] (and at the main path's live shape after phase 2) it is
   timed: the launch floor (fit_mask_floor_launch, an empty kernel with
   K1's grid), per call from Python, and the parent commit's
   wrapper and kernel in turns (parent, new, new, parent) when they have
   been placed under build/tree/ (see load_parent).
1b. K2, the fused fit mask + least-allocated score, against its plain
   version at [16, 8192, 6], [16, 700, 6], [16, 5001, 6], [4, 8192, 1]
   and [8, 5001, 12], and at its tiling's edges: TPL off its 4-template
   tile (17, 5, 3), N % 4 = 3, 1, 2, N < 4, TPL > 256; with zero-request
   templates, negative free, alloc = 0 columns and an exact fit. The mask
   must be bit-equal; the score bit-equal too, else the largest
   difference is printed and the run fails above 1e-6 relative. Timed
   like K1 (floor, per call, parent in turns) at [16, 8192, 6],
   [16, 5001, 6] and [8, 5001, 12]. No path of the system runs K2: it is
   a standalone kernel, as in the reference.
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
5. The system's own entry point: perf/harness.run_benchmark of
   SchedulingPodAffinity/5000 through the port's APIServer, informers,
   queue and Scheduler (split-phase readback, assume and bind), after one
   warm-up run of SchedulingPodAffinity/500 presized to 5,000 nodes.
   Requires 5000/5000 bound, 0 kernel guard trips, 0 unwound trailing
   assumes, no ERROR logged by the port (a "scheduling batch failed"
   included), K1 launched, requested <= allocatable on every node from the
   API server's bindings, and every measured pod in a zone that held an
   app=bench pod.
6. Latency: run_latency_benchmark at max(10, min(0.3 x the burst pods/s,
   2000)) pods/s with 500 pods (bench.py's rule); all 500 must bind, and
   K1 must be launched.

The kernel launch counts are set to 0 just before each main path (phases
2, 5 and 6) and read just after. The last lines are the card's name and
power limit (nvidia-smi), a ``{"kernels": [...]}`` JSON line with each
kernel's launches on the Scheduler's burst run (``launches``) and latency
run (``launches_latency``), its device time, bound, plain time, launch
floor (``floor_ms``), time per call from Python (``call_ms``) and the
parent's time (``parent_ms``, null without build/tree/), and
``{"ok": true, "device": {...}}``.

To time the parent commit against this tree in the same run, place its
kernel module and sources under the git-ignored build/tree/, e.g.
``git archive <parent> kubernetes_tpu_torch/ops/fit_kernels.py
kubernetes_tpu_torch/csrc | tar -x -C build/tree``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import logging
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

PARENT_TREE = Path(__file__).resolve().parent / "build" / "tree"
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


def load_parent():
    """The parent commit's kernel module, when its ``ops/fit_kernels.py`` and
    ``csrc/`` have been placed under the git-ignored build/tree/ (same
    relative paths) for a parent-against-change run; else None. It builds
    its own sources into build/tree/build/kernels/."""
    path = PARENT_TREE / "kubernetes_tpu_torch" / "ops" / "fit_kernels.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location("parent_fit_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(name: str, build_log: str) -> None:
    """One line per compiled kernel: registers, barriers, shared memory and
    spills, from nvcc's -Xptxas=-v output."""
    entry, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            log(f"[build] {name} ptxas: {entry}: {line.split(':', 1)[1].strip()}; {spill}")


def build_kernels():
    """Both kernel libraries, built by concurrent nvcc processes; the
    parent's too (at the same time) when load_parent() finds them."""
    from kubernetes_tpu_torch.ops import fit_kernels

    t0 = time.perf_counter()
    parent = load_parent()
    failed = []

    def build_parent():
        try:
            parent.build_all()
        except Exception as e:  # reported below; the run then fails
            failed.append(e)

    side = threading.Thread(target=build_parent) if parent else None
    if side:
        side.start()
    libs = fit_kernels.build_all()
    if side:
        side.join()
        if failed:
            raise failed[0]
    log(f"[build] {', '.join(l.path.name for l in libs.values())} built/loaded "
        f"in {time.perf_counter() - t0:.2f} s"
        + ("; the parent's kernels from build/tree/ beside them" if parent else ""))
    for name, lib in libs.items():
        ptxas_report(name, lib.build_log)
    bind_measurement_entries(libs)
    return parent


def bind_measurement_entries(libs) -> None:
    """argtypes of the entries only this script calls: each kernel's empty
    launch with its grid (the launch floor)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib, name, args in (
        ("fit_mask", "fit_mask_floor_launch", (I, I, P)),
        ("fit_least_alloc", "fit_least_alloc_floor_launch", (I, I, P)),
    ):
        fn = getattr(libs[lib].cdll, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def in_turns(timer, a, b):
    """timer(a), timer(b), timer(b), timer(a): (mean of a, mean of b, the
    four readings in that order)."""
    r = [timer(a), timer(b), timer(b), timer(a)]
    return (r[0] + r[3]) / 2, (r[1] + r[2]) / 2, r


def _fmt(xs) -> str:
    return "/".join(f"{x * 1e3:.3f}" for x in xs)


def k1_timings(req, free, parent, what: str) -> dict:
    """K1 at one shape: the kernel through its wrapper (against the parent
    commit's wrapper and kernel in turns when present), the launch floor,
    the plain version; device time from the CUDA graph replay and the time
    per call from Python."""
    from kubernetes_tpu_torch.ops import fit_kernels

    tpl, r = req.shape
    n = free.shape[0]
    lib = fit_kernels.library("fit_mask")
    new = lambda: fit_kernels.fit_mask(req, free)  # noqa: E731
    if not torch.equal(new(), fit_kernels.fit_mask_plain(req, free)):
        raise AssertionError(f"[K1] {what} TPL={tpl} N={n} R={r}: mask differs")
    res = {"parent_ms": None, "parent_call_ms": None}
    if parent is not None:
        old = lambda: parent.fit_mask(req, free)  # noqa: E731
        if not torch.equal(old(), new()):
            raise AssertionError(f"[K1] {what}: parent and change disagree")
        res["parent_ms"], res["ms"], dev = in_turns(device_ms, old, new)
        res["parent_call_ms"], res["call_ms"], call = in_turns(call_ms, old, new)
        turns = (f"parent/new/new/parent device {_fmt(dev)} us, per call "
                 f"from Python {_fmt(call)} us; ")
    else:
        res["ms"], res["call_ms"] = device_ms(new), call_ms(new)
        turns = "parent not present (build/tree/); "

    res["floor_ms"] = device_ms(lambda: lib.cdll.fit_mask_floor_launch(tpl, n, _stream()))
    res["plain_ms"] = device_ms(lambda: fit_kernels.fit_mask_plain(req, free))
    res["bound_ms"], res["bound_by"] = fit_bound(tpl, n, r)
    log(f"[K1] {what} TPL={tpl} N={n} R={r}: bit-equal; {turns}launch floor "
        f"{res['floor_ms'] * 1e3:.3f} us; plain {res['plain_ms'] * 1e3:.3f} us; bound {res['bound_ms'] * 1e3:.4f} us "
        f"({res['bound_by']}); kernel {res['ms'] * 1e3:.3f} us, per call "
        f"{res['call_ms'] * 1e3:.3f} us")
    return res


def phase_fit_kernel(device, parent):
    from kubernetes_tpu_torch.ops import fit_kernels

    cases = [
        (8, 8192, 6), (64, 8192, 6), (4, 700, 6), (16, 5001, 6),
        (8, 8192, 1), (8, 5001, 12),
        # N % 4 = 1, 2, 3; N < 4; TPL off K1's 4-template tile; TPL > 256
        (4, 8193, 6), (5, 8194, 6), (17, 8195, 6), (3, 1, 6), (2, 2, 16),
        (7, 3, 6), (300, 4099, 6), (257, 9, 5),
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
        log(f"[K1] TPL={tpl} N={n} R={r}: bit-equal; device time "
            f"kernel {ms:.5f} ms, plain {plain:.5f} ms; bound {bound:.6f} ms ({by})")
    for tpl in (8, 64):
        k1_timings(*fit_case(50 + tpl, tpl, 8192, 6, device), parent, "timed")
    log("[K1] no single PyTorch call computes this mask: library_ms is null")


def la_case(seed, tpl, n, r, device):
    """K2's inputs: sparse requests with a zero-request template, negative
    free on every 5th node, alloc = 0 on every 11th node's first column,
    and node 3 an exact fit for template 1."""
    g = np.random.default_rng(seed)
    req = g.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[g.random((tpl, r)) < 0.3] = 0
    req[0] = 0
    alloc = g.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * g.random((n, r)) * 0.9).astype(np.int32)
    free[::5] -= 70000
    alloc[::11, 0] = 0
    if n > 3 and tpl > 1:
        free[3] = req[1]
    return tuple(torch.tensor(x, device=device) for x in (req, free, alloc))


def la_bound(tpl: int, n: int, r: int):
    """(bound_ms, bound_by) for K2: free and alloc read once, the requests
    once, mask (1 B) and score (4 B) written once; against TPL*N*(3R + 1)
    float32 operations (per resource a division, a product and a sum, and
    one final division)."""
    bytes_ = 2 * n * r * 4 + tpl * r * 4 + tpl * n * 5
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = tpl * n * (3 * r + 1) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_timings(req, free, alloc, parent) -> dict:
    """K2 at one shape, as k1_timings: against the parent in turns when
    present, the launch floor, per call from Python."""
    from kubernetes_tpu_torch.ops import fit_kernels

    tpl, r = req.shape
    n = free.shape[0]
    lib = fit_kernels.library("fit_least_alloc")
    new = lambda: fit_kernels.fit_mask_least_alloc(req, free, alloc)  # noqa: E731
    res = {"parent_ms": None, "parent_call_ms": None}
    if parent is not None:
        old = lambda: parent.fit_mask_least_alloc(req, free, alloc)  # noqa: E731
        (om, os_), (nm, ns) = old(), new()
        if not (torch.equal(om, nm) and torch.equal(os_, ns)):
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: parent and change disagree")
        res["parent_ms"], res["ms"], dev = in_turns(device_ms, old, new)
        res["parent_call_ms"], res["call_ms"], call = in_turns(call_ms, old, new)
        turns = (f"parent/new/new/parent device {_fmt(dev)} us, per call "
                 f"from Python {_fmt(call)} us; ")
    else:
        res["ms"], res["call_ms"] = device_ms(new), call_ms(new)
        turns = "parent not present (build/tree/); "
    res["floor_ms"] = device_ms(
        lambda: lib.cdll.fit_least_alloc_floor_launch(tpl, n, _stream())
    )
    log(f"[K2] timed TPL={tpl} N={n} R={r}: {turns}launch floor "
        f"{res['floor_ms'] * 1e3:.3f} us; kernel {res['ms'] * 1e3:.3f} us, per "
        f"call {res['call_ms'] * 1e3:.3f} us")
    return res


def phase_least_alloc(device, parent):
    """K2 against its plain version on every listed shape. Returns the
    main shape's numbers for the kernels line."""
    from kubernetes_tpu_torch.ops import fit_kernels

    cases = [
        (16, 8192, 6), (16, 700, 6), (16, 5001, 6), (4, 8192, 1), (8, 5001, 12),
        # TPL off K2's template tile; N % 4 = 3, 1, 2; N < 4; TPL > 256
        (17, 8191, 6), (5, 4097, 6), (3, 1030, 6), (6, 3, 6), (1, 1, 16),
        (300, 2049, 6),
    ]
    timed = {(16, 8192, 6), (16, 5001, 6), (8, 5001, 12)}
    out = None
    worst = 0.0
    for i, (tpl, n, r) in enumerate(cases):
        req, free, alloc = la_case(100 + i, tpl, n, r, device)
        mask, score = fit_kernels.fit_mask_least_alloc(req, free, alloc)
        torch.cuda.synchronize()
        pm, ps = fit_kernels.fit_mask_least_alloc_plain(req, free, alloc)
        if not torch.equal(mask, pm):
            bad = int((mask != pm).sum())
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: {bad} mask entries differ")
        if not torch.isfinite(score).all():
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: non-finite scores")
        diff = (score - ps).abs()
        max_abs = float(diff.max())
        worst = max(worst, max_abs)
        if max_abs == 0.0:
            eq = "bit-equal"
        else:
            rel = float((diff / ps.abs().clamp(min=1e-30)).max())
            eq = f"largest difference {max_abs:.3e} abs, {rel:.3e} relative"
            if rel > 1e-6:
                raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: score {eq}")
        ms = device_ms(lambda: fit_kernels.fit_mask_least_alloc(req, free, alloc))
        plain = device_ms(lambda: fit_kernels.fit_mask_least_alloc_plain(req, free, alloc))
        bound, by = la_bound(tpl, n, r)
        log(f"[K2] TPL={tpl} N={n} R={r}: mask bit-equal, score {eq}; device "
            f"time kernel {ms:.5f} ms, plain {plain:.5f} ms; bound {bound:.6f} ms ({by})")
        if (tpl, n, r) in timed:
            t = k2_timings(req, free, alloc, parent)
            if out is None:
                out = {**t, "plain_ms": plain, "bound_ms": bound, "bound_by": by}
    out["max_abs_err"] = worst
    log("[K2] no single PyTorch call computes this mask and score: library_ms is null")
    return out


class ErrorLog(logging.Handler):
    """Collects every ERROR record the port logs (its copied modules keep
    the reference's logger names)."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []
        for name in ("kubernetes_tpu_torch", "kubernetes_tpu"):
            logging.getLogger(name).addHandler(self)

    def emit(self, record):
        self.records.append(record)

    def check(self, what: str) -> None:
        if self.records:
            for r in self.records[:5]:
                log(f"[{what}] ERROR logged: {r.name}: {r.getMessage()}")
            raise AssertionError(f"[{what}] {len(self.records)} ERROR records logged")


def phase_scheduler(device, card: str, errors: ErrorLog):
    """SchedulingPodAffinity/5000 through the port's APIServer and
    Scheduler (run_benchmark), after a warm-up of the same presize."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.scheduler.cache.nodeinfo import Snapshot
    from kubernetes_tpu_torch.utils.metrics import metrics

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    t0 = time.perf_counter()
    warm = run_benchmark(
        WORKLOADS["SchedulingPodAffinity/500"], presize_nodes=wl.num_nodes,
        device=device, timeout_s=300,
    )
    if warm.unscheduled:
        raise AssertionError(f"[scheduler] warm-up left {warm.unscheduled} pods unbound")
    log(f"[scheduler] warm-up SchedulingPodAffinity/500 presized to 5000 nodes: "
        f"{warm.scheduled}/{warm.num_measured_pods} bound, "
        f"{warm.throughput_pods_per_s:.1f} pods/s ({time.perf_counter() - t0:.1f} s in all)")
    errors.check("scheduler warm-up")

    server = APIServer()
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    res = run_benchmark(wl, device=device, server=server, timeout_s=300, quiet=False)
    k1 = fit_kernels.fit_mask.launches
    k2 = fit_kernels.fit_mask_least_alloc.launches
    trips, unwound = res.guard_trips, res.unwound_assumes
    blocking = metrics.counter("scheduler_wave_readbacks_blocking_total")
    log(f"[scheduler] SchedulingPodAffinity/5000 through APIServer + Scheduler: "
        f"{res.scheduled}/{res.num_measured_pods} bound in {res.duration_s:.3f} s = "
        f"{res.throughput_pods_per_s:.1f} pods/s; e2e p50/p90/p99 "
        f"{res.e2e_p50_ms:.1f}/{res.e2e_p90_ms:.1f}/{res.e2e_p99_ms:.1f} ms; "
        f"encode {res.encode_total_s:.3f} s, kernel {res.kernel_total_s:.3f} s; "
        f"{res.n_batches} batches, {res.n_readbacks} blocking readbacks = "
        f"{res.readbacks_per_batch:.3f} per batch ({blocking:.0f} blocking syncs "
        f"in all); pipeline depth {res.pipeline_depth}, max in flight "
        f"{res.max_waves_inflight}; K1 launches {k1}, K2 launches {k2}; guard "
        f"trips {trips}, unwound assumes {unwound}; card {card}")
    errors.check("scheduler")
    if res.scheduled != res.num_measured_pods or res.unscheduled:
        raise AssertionError(f"[scheduler] {res.unscheduled} measured pods not bound")
    if trips or unwound:
        raise AssertionError(f"[scheduler] {trips} guard trips, {unwound} unwound assumes")
    if k1 <= 0:
        raise AssertionError("[scheduler] the Scheduler never launched K1")

    nodes = server.list("nodes")[0]
    pods = server.list("pods")[0]
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    if unbound:
        raise AssertionError(f"[scheduler] {len(unbound)} pods unbound, e.g. {unbound[:3]}")
    snap = Snapshot.from_literals(pods, nodes)
    for ni in snap.node_info_list:
        for rname, amount in ni.requested.items():
            if amount > ni.allocatable.get(rname, 0):
                raise AssertionError(
                    f"[scheduler] {ni.node.metadata.name}: {rname} requested "
                    f"{amount} > allocatable {ni.allocatable.get(rname, 0)}"
                )
        if len(ni.pods) > ni.allocatable.get("pods", 0):
            raise AssertionError(f"[scheduler] {ni.node.metadata.name}: too many pods")
    zone_of = {n.metadata.name: n.metadata.labels["topology.kubernetes.io/zone"] for n in nodes}
    init_zones = {
        zone_of[p.spec.node_name] for p in pods
        if p.metadata.name.startswith("init-") and p.metadata.labels.get("app") == "bench"
    }
    measured = [p for p in pods if p.metadata.name.startswith("pod-")]
    stray = [p.metadata.name for p in measured if zone_of[p.spec.node_name] not in init_zones]
    if len(measured) != wl.num_measured_pods or stray:
        raise AssertionError(
            f"[scheduler] {len(measured)} measured pods; {len(stray)} outside "
            "the zones that held an app=bench pod"
        )
    log(f"[scheduler] checked from the API server: {len(pods)} pods bound, "
        f"requested <= allocatable on all {len(nodes)} nodes, every measured "
        f"pod in one of the {len(init_zones)} zones that held an app=bench pod")
    return res, k1, k2


def phase_latency(device, burst_pods_per_s: float, errors: ErrorLog):
    from kubernetes_tpu_torch.perf.harness import run_latency_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    rate = max(10.0, min(burst_pods_per_s * 0.3, 2000.0))
    lat = run_latency_benchmark(
        WORKLOADS["SchedulingPodAffinity/5000"], rate, n_pods=500, device=device,
        timeout_s=120,
    )
    for stage, st in (lat.stage_waterfall or {}).items():
        log(f"[latency]   stage {stage}: {st.get('count', 0)} spans, p50 "
            f"{st.get('p50_ms', 0.0):.2f} ms, p99 {st.get('p99_ms', 0.0):.2f} ms")
    log(f"[latency] SchedulingPodAffinity/5000 at {rate:.1f} pods/s, 500 pods: "
        f"{lat.scheduled} bound; pod p50 {lat.pod_p50_ms:.2f} ms, p99 "
        f"{lat.pod_p99_ms:.2f} ms; queue-wait p99 {lat.queue_wait_p99_ms:.2f} ms; "
        f"in-flight p99 {lat.in_flight_p99_ms:.2f} ms; readbacks per bind "
        f"{lat.readbacks_per_bind:.4f}; pipeline depth {lat.pipeline_depth}, "
        f"max in flight {lat.max_waves_inflight}; guard trips {lat.guard_trips}, "
        f"unwound assumes {lat.unwound_assumes}")
    errors.check("latency")
    if lat.scheduled != 500:
        raise AssertionError(f"[latency] {lat.scheduled}/500 bound")
    return lat


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

    errors = ErrorLog()
    parent = build_kernels()
    phase_fit_kernel(device, parent)
    k2 = phase_least_alloc(device, parent)

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
    got = fit_kernels.fit_mask(req, free)
    max_abs_err = float((got.int() - fit_kernels.fit_mask_plain(req, free).int()).abs().max())
    k1 = k1_timings(req, free, parent, "main-path shape")
    log(f"[K1] main-path shape: max |kernel - plain| {max_abs_err}")

    phase_parity(mp, device)

    res, k1_launches, k2_launches = phase_scheduler(device, card, errors)
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    phase_latency(device, res.throughput_pods_per_s, errors)
    k1_latency = fit_kernels.fit_mask.launches
    k2_latency = fit_kernels.fit_mask_least_alloc.launches
    log(f"[latency] K1 launches {k1_latency}, K2 launches {k2_latency}")
    if k1_latency <= 0:
        raise AssertionError("[latency] the Scheduler never launched K1")

    kernels = {
        "kernels": [
            {
                "name": "fit_mask",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_mask.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:120",
                "launches": k1_launches,
                "launches_latency": k1_latency,
                "max_abs_err": max_abs_err,
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
                "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"],
                "library_ms": None,
                "floor_ms": k1["floor_ms"],
                "call_ms": k1["call_ms"],
                "parent_ms": k1["parent_ms"],
                "parent_call_ms": k1["parent_call_ms"],
            },
            {
                "name": "fit_mask_least_alloc",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_least_alloc.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:69",
                "path": "standalone",
                "launches": k2_launches,
                "launches_latency": k2_latency,
                "max_abs_err": k2["max_abs_err"],
                "ms": k2["ms"],
                "plain_ms": k2["plain_ms"],
                "bound_ms": k2["bound_ms"],
                "bound_by": k2["bound_by"],
                "library_ms": None,
                "floor_ms": k2["floor_ms"],
                "call_ms": k2["call_ms"],
                "parent_ms": k2["parent_ms"],
                "parent_call_ms": k2["parent_call_ms"],
            },
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
