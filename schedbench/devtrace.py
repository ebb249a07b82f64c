"""The traced run's reduction: ``torch.profiler`` over whole batches of the
window, read in memory (no trace file is written).

The profiler's clock is not ``time.monotonic``. ``Clock.mark`` records a
``record_function`` event at a known monotonic time, and the offset
between the two maps the window's edges onto the trace. Device time is
every CUDA event (kernels, copies, sets) inside the window; busy is
their union. The longest idle gaps are named by what the host did
through most of them: a garbage collection the run's ``gc.callbacks``
saw, a span of the benchmark's own (``schedbench.*``), or the longest
host operator at the gap's middle.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

MARK = "schedbench.clock"


class Clock:
    def __init__(self):
        self.marks: List[float] = []

    def mark(self) -> None:
        import torch

        with torch.profiler.record_function(MARK):
            self.marks.append(time.monotonic())


class GcPauses:
    """Every collection's (start, end, generation) while installed (every
    run installs one: a few microseconds a collection)."""

    def __init__(self):
        self.pauses: List[Tuple[float, float, int]] = []
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.monotonic()
        else:
            self.pauses.append((self._t0, time.monotonic(), info.get("generation", -1)))

    def summary(self, t0: float, t1: float) -> dict:
        """Collections that started in [t0, t1]: count and seconds by
        generation."""
        out = {}
        for p0, p1, g in self.pauses:
            if t0 <= p0 <= t1:
                n, s = out.get(f"gen{g}", (0, 0.0))
                out[f"gen{g}"] = (n + 1, s + (p1 - p0))
        return out

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def _events(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).rsplit(".", 1)[-1]
        t0 = e.start_ns()
        out.append((dev, e.name(), t0, t0 + e.duration_ns()))
    return out


def _union(intervals) -> float:
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce(prof, clock: Clock, t_open: float, t_close: float, batches: int,
           gc_pauses: Optional[GcPauses] = None, n_ops: int = 10) -> Dict:
    evs = _events(prof)
    marks = sorted(t0 for dev, name, t0, _ in evs if name == MARK)
    if not marks or not clock.marks:
        raise RuntimeError("the trace holds no clock mark")
    # ns of the trace at monotonic 0 (the first mark pairs with the first)
    offset = marks[0] - clock.marks[0] * 1e9
    lo, hi = t_open * 1e9 + offset, t_close * 1e9 + offset
    device, kernels = [], []
    by_name: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for dev, name, a, b in evs:
        if dev != "CUDA" or b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        device.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if not (name.startswith("Memcpy") or name.startswith("Memset")):
            kernels.append((name, a, b))
            calls[name] = calls.get(name, 0) + 1
    busy_s = _union(device) / 1e9
    window_s = t_close - t_open
    gaps = []
    prev = lo
    for a, b in sorted(device):
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    host = [(a, b, name) for dev, name, a, b in evs if dev == "CPU" and name != MARK]
    pauses = [
        (p0 * 1e9 + offset, p1 * 1e9 + offset, g)
        for p0, p1, g in (gc_pauses.pauses if gc_pauses else [])
    ]
    idle = []
    for length, a, b in gaps[:n_ops]:
        idle.append([_name_gap(a, b, host, pauses), length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_ops]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_s": sum(by_name.values()),
        "launches": len(kernels),
        "kernel_s": by_name,
        "kernel_calls": calls,
        "device_ops": [[n[:96], s] for n, s in ops],
        "idle_gaps": idle,
        "batches": batches,
    }


def _overlap(a, b, spans) -> float:
    return sum(max(0.0, min(b, s1) - max(a, s0)) for s0, s1 in spans)


def _name_gap(a, b, host, pauses) -> str:
    """The host activity that covers most of the gap [a, b]: a collection
    by its generation, a span of the benchmark's own, or the longest host
    operator; "host:python" where none covers a fifth of it."""
    cover = {}
    for g in sorted({g for _p0, _p1, g in pauses}):
        cover[f"gc.gen{g}"] = _overlap(a, b, [(p0, p1) for p0, p1, gg in pauses if gg == g])
    ours = {}
    for h0, h1, name in host:
        if h1 > a and h0 < b and name.startswith("schedbench."):
            ours.setdefault(name, []).append((h0, h1))
    for name, spans in ours.items():
        cover[name] = _overlap(a, b, spans)
    mid = 0.5 * (a + b)
    longest = max(
        ((h1 - h0, name) for h0, h1, name in host if h0 <= mid <= h1),
        default=None,
    )
    if longest is not None:
        cover.setdefault(f"host:{longest[1]}", min(longest[0], b - a))
    if not cover:
        return "host:python"
    name, secs = max(cover.items(), key=lambda kv: kv[1])
    return name if secs >= 0.2 * (b - a) else "host:python"
