"""One run of one cell: set-up, the warm batches, the window, the drain
and the checks.

Each run builds one in-process ``APIServer`` and one ``Scheduler`` with
the configuration's pinned settings, creates the cluster and its init
pods, presizes the snapshot, then drives the cell's traffic (stream.py)
for ``warm_batches`` whole batches, collects garbage once and opens the
window (window.py). Once it has closed the generator stops, the peak
device memory is read, every created pod is waited for, the Scheduler
stops, and the reference (reference.py) judges the run.

Every metric, end-to-end and per-layer, is a reader of its own,
``schedbench/metrics/<name>.py``, found by the metric's name: each may
list the histograms it reads in ``HISTOGRAMS`` and gives ``read(ctx)`` a
number or None. The traffic's loop is ``schedbench/loops/<loop>.py``,
found by the traffic file's ``loop``, whose ``make`` builds the load.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import cluster, reference, window
from .devtrace import GcPauses
from .held import HeldBatch
from .stream import BindClock, PodStream

ROOT = Path(__file__).resolve().parent.parent


class RunFailed(RuntimeError):
    pass


def load_limits() -> dict:
    return cluster.load_json(Path(__file__).with_name("limits.json"))


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number beside its limit ({"value", "max"} or {"value", "min"});
    a number the limits do not name is reported with no limit."""
    out = {}
    for name, v in numbers.items():
        lim = limits.get(name, {})
        out[name] = {"value": v, **lim}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    for c in checks.values():
        v = c["value"]
        if "max" in c and not v <= c["max"]:
            return False
        if "min" in c and not v >= c["min"]:
            return False
    return True


class Snapshot:
    """The program's counters and the readers' histograms at one moment."""

    def __init__(self, metrics, hists):
        self.counters = {
            (n, tuple(sorted(l.items()))): v for n, l, v in metrics.snapshot_counters()
        }
        self.hists = {}
        for name, labels in hists:
            h = metrics.histogram(name, labels)
            self.hists[(name, tuple(sorted(labels.items())))] = (
                (h.total, h.n) if h is not None else (0.0, 0)
            )


class Context:
    """What a metric's reader reads: the window, the process's start, the
    program's counters and histograms across the window, the load's call
    times in it, the traced window's reduction, and the configuration."""

    def __init__(self, win, t_start, s0: Snapshot, s1: Snapshot, api_calls, trace, cfg):
        self.window = win
        self.t_start = t_start
        self._s0, self._s1 = s0, s1
        self.api_calls = api_calls
        self.trace = trace
        self.cfg = cfg

    def counter(self, name: str, labels: Optional[dict] = None) -> float:
        k = (name, tuple(sorted((labels or {}).items())))
        return self._s1.counters.get(k, 0.0) - self._s0.counters.get(k, 0.0)

    def histogram(self, name: str, labels: Optional[dict] = None):
        """(sum, count) of the observations across the window."""
        k = (name, tuple(sorted((labels or {}).items())))
        t1, n1 = self._s1.hists.get(k, (0.0, 0))
        t0, n0 = self._s0.hists.get(k, (0.0, 0))
        return t1 - t0, n1 - n0


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    t_start: float,
    root: Path = ROOT,
    adjust: Optional[Callable[[dict, dict], None]] = None,
    fault: Optional[Callable] = None,
    control: bool = False,
) -> dict:
    """One run. `adjust(cfg, traffic)` may shrink the cell (the CPU tests);
    `fault(sched)` may break the program underneath (the fault tests);
    `control` adds the controls' readings on the held batch."""
    import torch

    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops.encoding import RES_CPU, RES_MEM, RES_PODS
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
    from kubernetes_tpu_torch.utils.metrics import metrics
    from kubernetes_tpu_torch.utils.tracing import tracer

    bench = cluster.load_json(root / "BENCHMARK.json")
    _cell, _centry, cfg, traffic = cluster.cell_files(root, bench, workload)
    if adjust is not None:
        adjust(cfg, traffic)
    # a loop with no file of its own is refused here
    loop = cluster.load_named("loops", traffic["loop"])
    # the cell's metrics: with --trace 1 its per-layer ones, else its
    # end-to-end ones, each metric that names no cells being every cell's
    metric_entries = {
        m["name"]: m
        for m in bench["per_layer" if trace else "end_to_end"]
        if workload in m.get("workloads", [workload])
    }
    readers = {name: cluster.load_named("metrics", name) for name in metric_entries}
    hists = [h for r in readers.values() for h in getattr(r, "HISTOGRAMS", [])] + [
        ("scheduling_stage_duration_seconds", {"stage": s}) for s in ("encode", "kernel")
    ]
    dev = torch.device(device)
    batch_size = int(cfg["scheduler"]["device_batch_size"])
    warm_batches = int(traffic["warm_batches"])

    metrics.reset()
    tracer.reset()
    server = APIServer(watch_history=int(cfg["store_watch_history"]))
    pool = cluster.PodPool(cfg, seed)
    stream = PodStream(server, pool.names)
    clock_binds = BindClock(server)
    sched = Scheduler(
        server, KubeSchedulerConfiguration(**cfg["scheduler"]), device=dev,
        seed=int(seed),
    )
    with sched.cache.lock:
        sched.cache.encoder.presize_for_cluster(cfg["num_nodes"])
    for n in cluster.make_nodes(cfg):
        server.create("nodes", n)
    held = HeldBatch(sched, server, batch_size, (RES_CPU, RES_MEM, RES_PODS))
    if fault is not None:
        fault(sched)
    span = None
    if trace:
        span = torch.profiler.record_function
    gen = loop.make(server, stream, pool, traffic, cfg, span=span)
    prof = clock = None
    snaps: List[Snapshot] = []
    win = None
    peak = 0
    gc_seen = GcPauses().__enter__()
    try:
        sched.start()
        init = cluster.init_pods(cfg, seed)
        for p in init:
            server.create("pods", p)
        if not stream.wait_bound(len(init), 300.0):
            raise RunFailed(f"init pods: {stream.n_bound}/{len(init)} bound")
        t_gen = time.monotonic()
        gen.start()
        deadline = time.monotonic() + 300.0
        # the first pops race the first creates: count the batches of at
        # least half the pinned size
        while sum(
            1 for r in clock_binds.runs if r.t > t_gen and 2 * r.size >= batch_size
        ) < warm_batches:
            if gen.failed:
                raise RunFailed(f"generator: {gen.failed[0]}")
            if time.monotonic() > deadline:
                raise RunFailed("warm batches did not come")
            time.sleep(0.02)
        t_gc = time.monotonic()
        gc.collect()
        gc_setup_s = time.monotonic() - t_gc
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from .devtrace import Clock

            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            clock = Clock()
            clock.mark()
        t_ready = time.monotonic()
        first = len(clock_binds.runs)
        noticed = first
        armed = False
        deadline = t_ready + seconds + 300.0
        while win is None:
            time.sleep(0.05)
            runs = clock_binds.runs
            if len(runs) > noticed:
                s = Snapshot(metrics, hists)
                snaps.extend([s] * (len(runs) - noticed))
                noticed = len(runs)
                win = window.whole_batch_window(runs[first:noticed], t_ready, seconds)
                if not armed and any(r.t > t_ready for r in runs[first:noticed]):
                    # the window is open: hold the 1st-3rd launch from now
                    held.arm(1 + int(seed) % 3)
                    armed = True
            if gen.failed:
                raise RunFailed(f"generator: {gen.failed[0]}")
            if time.monotonic() > deadline:
                raise RunFailed("the window did not close")
        if trace:
            clock.mark()
            prof.__exit__(None, None, None)
        gen.stop()
        if dev.type == "cuda":
            peak = int(torch.cuda.max_memory_allocated(dev))
        drain_deadline = time.monotonic() + float(traffic["drain_timeout_s"])
        while stream.n_bound_measured < gen.created and time.monotonic() < drain_deadline:
            time.sleep(0.05)
    finally:
        gen.stop()
        sched.stop()
        stream.stop()
        gc_seen.__exit__(None, None, None)

    runs = clock_binds.runs[first:]
    i_open = next(i for i, r in enumerate(runs) if r.t == win.t_open)
    i_close = next(i for i, r in enumerate(runs) if r.t == win.t_close)
    s_open, s_close = snaps[i_open], snaps[i_close]
    events = list(stream.events())

    # ---- the checks ----
    numbers: Dict[str, float] = {}
    numbers.update(reference.check_binds(events, cfg, gen.created))
    numbers["rebind_events"] = stream.rebinds
    hd = held.fetch()
    held_numbers, start = reference.check_held(hd, cfg, events, clock_binds.runs)
    numbers.update(held_numbers)
    numbers["held_in_window"] = int(hd is not None and win.t_open <= hd["t"] <= win.t_close)
    # the watch saw every pod the bind calls bound
    numbers["watch_missed"] = clock_binds.bound - stream.n_bound
    if control and hd is not None:
        for kind in reference.CONTROLS:
            ctl = reference.judge_outputs(reference.control_held(hd, cfg, start, kind), cfg, start)
            numbers.update({f"{kind}.{k}": v for k, v in ctl.items()})
    checks = judge(numbers, load_limits())
    correct = passed({k: v for k, v in checks.items() if "." not in k})

    calls = gen.calls_between(win.t_open, win.t_close)
    result = {
        "correct": correct,
        "attempted": gen.created,
        "failed": int(numbers["unbound"] + numbers["unknown_node"] + numbers["double_bind"]
                      + numbers["over_allocatable"] + numbers["affinity"]),
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    red = None
    if trace:
        from . import devtrace

        red = devtrace.reduce(prof, clock, win.t_open, win.t_close, win.batches, gc_seen)
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    ctx = Context(win, t_start, s_open, s_close, calls, red, cfg)
    for name, r in readers.items():
        v = r.read(ctx)
        if v is not None:
            result["metrics"][name] = {"value": float(v), "unit": metric_entries[name]["unit"]}
    # what the window held, for the reader of the result line: its edges,
    # the collector's passes by generation, the load's call time, the
    # stage times, and every bind call after the first create as (s from
    # that create, pods), the warm batches first
    result["window"] = {
        "t_open": win.t_open, "t_close": win.t_close, "seconds": win.seconds,
        "pods": win.pods, "batches": win.batches, "setup_s": win.t_open - t_start,
        "measured_created": gen.created,
        "measured_bound": stream.n_bound_measured,
        "t_ready": round(t_ready - t_gen, 3),
        "held_t": round(hd["t"] - t_gen, 3) if hd else None,
        "setup_gc_s": gc_setup_s,
        "gc": gc_seen.summary(win.t_open, win.t_close),
        "api_s": sum(calls),
        **{
            f"{stage}_s": ctx.histogram("scheduling_stage_duration_seconds", {"stage": stage})[0]
            for stage in ("encode", "kernel")
        },
        "runs": [[round(r.t - t_gen, 3), r.size] for r in clock_binds.runs if r.t > t_gen],
    }
    result["checks"] = checks
    return result
