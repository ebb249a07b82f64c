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
4b. The serial lattice on one 512-pod batch of the
   main path's workload at 5,000 nodes (n_cap 8192, v_cap 8192, t_cap
   64), on the card and then on the CPU from the same snapshot and tie
   noise: chosen, feasible_count and resolvable must be equal, the
   largest score difference is printed; the card's run on the batch's
   first 128 pods is profiled (device busy against wall).
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
7. [serial]: SchedulingPodAffinity/5000 through run_benchmark with
   use_wave=False (the serial lattice at batch 4096): the gate of phase 5
   (5000/5000 bound, bindings checked from the API server, 0 guard trips,
   no ERROR logged); pods/s, batches and serial-kernel seconds per batch.
8. [preempt]: run_preemption_benchmark at the reference's defaults
   (1,000 full nodes, a burst of 1,000 priority-100 pods needing
   victims). Requires all 1,000 bound, vector attempts > 0, no
   kernel_error fallback and no preemption guard trip.
9. [standby]: start_standby() on SchedulingPodAffinity/5000's cluster,
   500 pods queued while it stands by, promote(), all 500 bound; the
   warm-up seconds and the promotion ms. Requires exactly one standby
   warm-up and all 500 bound, with the bindings checked.

The kernel launch counts are set to 0 just before each main path (phases
2, 5, 6, 7, 8 and 9) and read just after. The last lines are the card's
name and power limit (nvidia-smi), a ``{"kernels": [...]}`` JSON line with
each kernel's launches on the Scheduler's burst run (``launches``), the
latency run (``launches_latency``), the serial, preemption and standby
runs (``launches_serial``, ``launches_preempt``, ``launches_standby``),
its device time, bound, plain time, launch floor (``floor_ms``), time per
call from Python (``call_ms``) and the parent's time (``parent_ms``, null
without build/tree/), and ``{"ok": true, "device": {...}}``.

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


def check_bindings(server, n_measured: int, what: str) -> None:
    """The correctness gate on the API server's bindings: every pod bound,
    requested <= allocatable on every node, and every measured pod
    (``pod-*``) in a zone that held an app=bench pod (its required zone
    affinity)."""
    from kubernetes_tpu_torch.scheduler.cache.nodeinfo import Snapshot

    nodes = server.list("nodes")[0]
    pods = server.list("pods")[0]
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    if unbound:
        raise AssertionError(f"[{what}] {len(unbound)} pods unbound, e.g. {unbound[:3]}")
    snap = Snapshot.from_literals(pods, nodes)
    for ni in snap.node_info_list:
        for rname, amount in ni.requested.items():
            if amount > ni.allocatable.get(rname, 0):
                raise AssertionError(
                    f"[{what}] {ni.node.metadata.name}: {rname} requested "
                    f"{amount} > allocatable {ni.allocatable.get(rname, 0)}"
                )
        if len(ni.pods) > ni.allocatable.get("pods", 0):
            raise AssertionError(f"[{what}] {ni.node.metadata.name}: too many pods")
    zone_of = {n.metadata.name: n.metadata.labels["topology.kubernetes.io/zone"] for n in nodes}
    init_zones = {
        zone_of[p.spec.node_name] for p in pods
        if p.metadata.name.startswith("init-") and p.metadata.labels.get("app") == "bench"
    }
    measured = [p for p in pods if p.metadata.name.startswith("pod-")]
    stray = [p.metadata.name for p in measured if zone_of[p.spec.node_name] not in init_zones]
    if len(measured) != n_measured or stray:
        raise AssertionError(
            f"[{what}] {len(measured)} measured pods; {len(stray)} outside "
            "the zones that held an app=bench pod"
        )
    log(f"[{what}] checked from the API server: {len(pods)} pods bound, "
        f"requested <= allocatable on all {len(nodes)} nodes, every measured "
        f"pod in one of the {len(init_zones)} zones that held an app=bench pod")


def phase_scheduler(device, card: str, errors: ErrorLog):
    """SchedulingPodAffinity/5000 through the port's APIServer and
    Scheduler (run_benchmark), after a warm-up of the same presize."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
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

    check_bindings(server, wl.num_measured_pods, "scheduler")
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
        profile_device(
            f"wave kernel, one batch of {cfg.batch_size} pods, {prep.n_waves} waves",
            lambda: kern_fit.with_noise(
                clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise
            ),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] wave kernel device time not measured: {e}")


def profile_device(what: str, fn) -> dict:
    """Where one call of fn() spends its time: wall time against the sum of
    device kernel time (torch.profiler), and the kernels that take most of
    it. Measurement only: says "not measured" when the profiler sees no
    device activity. Returns {"wall_ms", "busy_ms", "launches"} (busy_ms
    None when not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[profile] {what}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler saw no device activity)")
        return {"wall_ms": wall_ms, "busy_ms": None, "launches": None}
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms in {launches} kernel launches "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f})")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3, "launches": launches}


def serial_batch_check(mp, device) -> dict:
    """One 512-pod batch of the main path's workload through the serial
    lattice at 5,000 nodes on the card, then the same snapshot, batch and
    tie noise through the port's own CPU run (the path the tier-1 tests
    hold against the JAX reference): chosen, feasible_count and
    resolvable must be equal; the score's largest difference is printed.
    The card's run is profiled (device busy against wall)."""
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch

    enc = mp["enc"]
    pods = [mp["factory"](200000 + i) for i in range(512)]
    eb = encode_pod_batch(enc, pods, pad_to=512)
    snap = enc.flush()
    n = snap.valid.shape[0]
    noise = torch.rand((512, n), generator=mp["rng"], device=device)
    kern = make_schedule_batch(enc.cfg.v_cap)
    kern(snap, eb.batch, mp["weights"], noise)  # first launch: allocator warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = kern(snap, eb.batch, mp["weights"], noise)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    def cpu(nt):
        return type(nt)(*(t.cpu() for t in nt))

    t0 = time.perf_counter()
    ref = kern(cpu(snap), cpu(eb.batch), mp["weights"].cpu(), noise.cpu())
    cpu_s = time.perf_counter() - t0
    for f in ("chosen", "feasible_count", "resolvable"):
        if not torch.equal(getattr(res, f).cpu(), getattr(ref, f)):
            bad = int((getattr(res, f).cpu() != getattr(ref, f)).sum())
            raise AssertionError(f"[serial] 512-pod batch: {f} differs at {bad} entries")
    placed = ref.chosen >= 0
    sa, sb = res.score.cpu()[placed], ref.score[placed]
    if not torch.isfinite(sa).all():
        raise AssertionError("[serial] 512-pod batch: non-finite scores")
    max_diff = float((sa - sb).abs().max()) if int(placed.sum()) else 0.0
    log(f"[serial] one 512-pod batch at {int(snap.valid.sum())} nodes (n_cap {n}, "
        f"v_cap {enc.cfg.v_cap}, t_cap {snap.eterm_w.shape[1]}): card {card_s:.3f} s, "
        f"CPU {cpu_s:.3f} s; chosen, feasible_count, resolvable equal "
        f"({int(placed.sum())} placed); largest score difference {max_diff}")
    if int(placed.sum()) == 0:
        raise AssertionError("[serial] 512-pod batch placed nothing")
    # the profile takes the batch's first 128 pods: the profiler's own
    # bookkeeping grows with the ~140 launches of every pod step
    sub = type(eb.batch)(*(t[:128] for t in eb.batch))
    try:
        prof = profile_device(
            "serial lattice, one 128-pod batch",
            lambda: kern(snap, sub, mp["weights"], noise[:128]),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] serial lattice device time not measured: {e}")
        prof = {}
    return {"card_s": card_s, "cpu_s": cpu_s, "max_score_diff": max_diff, **prof}


def phase_serial(device, card: str, errors: ErrorLog) -> dict:
    """SchedulingPodAffinity/5000 through run_benchmark with use_wave=False:
    the serial lattice at the accelerator settings (batch 4096, 5,000
    nodes); the correctness gate of [scheduler]."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import default_config, run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    server = APIServer()
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    res = run_benchmark(
        wl, sched_config=default_config(use_wave=False), device=device,
        server=server, timeout_s=600, quiet=False,
    )
    k1 = fit_kernels.fit_mask.launches
    k2 = fit_kernels.fit_mask_least_alloc.launches
    per_batch = res.kernel_total_s / res.n_batches if res.n_batches else 0.0
    log(f"[serial] SchedulingPodAffinity/5000, use_wave=False, through APIServer + "
        f"Scheduler: {res.scheduled}/{res.num_measured_pods} bound in "
        f"{res.duration_s:.3f} s = {res.throughput_pods_per_s:.1f} pods/s; "
        f"{res.n_batches} batches, serial kernel {res.kernel_total_s:.3f} s = "
        f"{per_batch:.3f} s per batch; e2e p50/p99 {res.e2e_p50_ms:.1f}/"
        f"{res.e2e_p99_ms:.1f} ms; encode {res.encode_total_s:.3f} s; K1 launches "
        f"{k1}, K2 launches {k2}; guard trips {res.guard_trips}, unwound assumes "
        f"{res.unwound_assumes}; card {card}")
    errors.check("serial")
    if res.scheduled != res.num_measured_pods or res.unscheduled:
        raise AssertionError(f"[serial] {res.unscheduled} measured pods not bound")
    if res.guard_trips or res.unwound_assumes:
        raise AssertionError(f"[serial] {res.guard_trips} guard trips")
    check_bindings(server, wl.num_measured_pods, "serial")
    return {"res": res, "k1": k1, "k2": k2, "per_batch_s": per_batch}


def phase_preempt(device, card: str, errors: ErrorLog) -> dict:
    """run_preemption_benchmark at the reference's defaults: 1,000 full
    nodes (4 x 1-cpu priority-0 pods each), a burst of 1,000 2-cpu
    priority-100 pods. Fails unless every preemptor is bound, the batched
    pass served attempts, no kernel_error fallback and no guard trip."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_preemption_benchmark

    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    res = run_preemption_benchmark(device=device, timeout_s=600)
    k1 = fit_kernels.fit_mask.launches
    k2 = fit_kernels.fit_mask_least_alloc.launches
    log(f"[preempt] {res.num_nodes} full nodes, burst {res.burst_pods}: "
        f"scheduled {res.scheduled}, all bound in {res.time_to_all_bound_s:.3f} s; "
        f"victims evicted {res.victims_evicted}; select batches "
        f"{res.select_batches}; vector attempts {res.vector_attempts}; host-walk "
        f"fallbacks {res.host_walk_fallbacks} (by reason "
        f"{json.dumps(res.fallbacks_by_reason, sort_keys=True)}); guard trips "
        f"{res.guard_trips}; oracle divergences {res.oracle_divergences}; select "
        f"p50/p99 {res.select_p50_ms:.3f}/{res.select_p99_ms:.3f} ms; K1 launches "
        f"{k1}, K2 launches {k2}; card {card}")
    errors.check("preempt")
    if res.scheduled != res.burst_pods:
        raise AssertionError(f"[preempt] {res.scheduled}/{res.burst_pods} bound")
    if res.vector_attempts <= 0:
        raise AssertionError("[preempt] the batched victim selection served no attempt")
    if res.fallbacks_by_reason.get("kernel_error", 0):
        raise AssertionError("[preempt] kernel_error fallbacks")
    if res.guard_trips:
        raise AssertionError(f"[preempt] {res.guard_trips} guard trips")
    return {"res": res, "k1": k1, "k2": k2}


def phase_standby(device, card: str, errors: ErrorLog) -> dict:
    """A warm standby on SchedulingPodAffinity/5000's cluster (5,000 nodes,
    its 1,000 initial pods bound): start_standby(), 500 measured pods
    queued while it stands by, promote(), every one bound. Fails unless
    the standby pre-warmed exactly once and all 500 are bound."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import default_config
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler.ha import COUNTER_STANDBY_WARMUPS
    from kubernetes_tpu_torch.utils.metrics import metrics

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    nodes, init_pods, factory = build_workload(wl)
    server = APIServer()
    for n in nodes:
        server.create("nodes", n)
    for i, p in enumerate(init_pods):
        p.spec.node_name = nodes[(7 * i) % len(nodes)].metadata.name
        server.create("pods", p)
    metrics.reset()
    sched = Scheduler(server, default_config(), device=device)
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    n_pods = 500
    try:
        t0 = time.perf_counter()
        sched.start_standby(identity="standby")
        warm_s = time.perf_counter() - t0
        warmups = metrics.counter(COUNTER_STANDBY_WARMUPS)
        k1_warm = fit_kernels.fit_mask.launches
        for i in range(n_pods):
            server.create("pods", factory(i))
        deadline = time.monotonic() + 60
        while len(sched.queue) < n_pods and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = len(sched.queue)
        t1 = time.perf_counter()
        sched.promote()
        promote_ms = (time.perf_counter() - t1) * 1e3
        deadline = time.monotonic() + 120
        bound = 0
        while time.monotonic() < deadline:
            bound = server.count(
                "pods", lambda p: p.metadata.name.startswith("pod-") and bool(p.spec.node_name)
            )
            if bound >= n_pods:
                break
            time.sleep(0.02)
        bound_s = time.perf_counter() - t1
    finally:
        sched.stop()
    k1 = fit_kernels.fit_mask.launches
    k2 = fit_kernels.fit_mask_least_alloc.launches
    adopted = metrics.counter("scheduler_ha_adoptions_total", {"outcome": "pending"})
    log(f"[standby] {len(nodes)} nodes: start_standby (informer sync, snapshot, kernel "
        f"pre-warm) {warm_s:.3f} s, standby warm-ups {warmups:.0f} (K1 launches "
        f"{k1_warm}); {queued} pods queued while standing by; promote "
        f"{promote_ms:.1f} ms (adopted {adopted:.0f} pending); {bound}/{n_pods} "
        f"bound {bound_s:.3f} s after the promotion; K1 launches {k1}, K2 "
        f"launches {k2}; card {card}")
    errors.check("standby")
    if warmups != 1:
        raise AssertionError(f"[standby] {warmups} standby warm-ups, want 1")
    if bound != n_pods:
        raise AssertionError(f"[standby] {bound}/{n_pods} bound")
    check_bindings(server, n_pods, "standby")
    return {"k1": k1, "k2": k2, "warm_s": warm_s, "promote_ms": promote_ms}


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
    serial_batch_check(mp, device)

    res, k1_launches, k2_launches = phase_scheduler(device, card, errors)
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0
    phase_latency(device, res.throughput_pods_per_s, errors)
    k1_latency = fit_kernels.fit_mask.launches
    k2_latency = fit_kernels.fit_mask_least_alloc.launches
    log(f"[latency] K1 launches {k1_latency}, K2 launches {k2_latency}")
    if k1_latency <= 0:
        raise AssertionError("[latency] the Scheduler never launched K1")

    serial = phase_serial(device, card, errors)
    preempt = phase_preempt(device, card, errors)
    if preempt["k1"] <= 0:
        raise AssertionError("[preempt] the burst's wave path never launched K1")
    standby = phase_standby(device, card, errors)
    if standby["k1"] <= 0:
        raise AssertionError("[standby] the warm-up and the promoted loop never launched K1")

    def launches(k):
        return {
            "launches_serial": serial[k],
            "launches_preempt": preempt[k],
            "launches_standby": standby[k],
        }

    kernels = {
        "kernels": [
            {
                "name": "fit_mask",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_mask.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:120",
                "launches": k1_launches,
                "launches_latency": k1_latency,
                **launches("k1"),
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
                **launches("k2"),
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
