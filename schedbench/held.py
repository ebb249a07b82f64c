"""Holds one wave batch of the window for the reference.

The Scheduler sends every wave launch through ``_launch_wave_kernel``,
its seam for fault injection. ``HeldBatch`` wraps that seam on
the one Scheduler of the run: once armed, it counts full-size launches
and, at the n-th (drawn from the seed), gives the launch a kernel whose
``with_noise`` copies the snapshot's pod-count and resource columns on
the device before the kernel updates them, then copies the kernel's
outputs. The copies stay on the device until the window has closed;
every other launch passes straight through.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


class _Capturing:
    """The launch's kernel with its state and outputs copied on the way."""

    def __init__(self, kern, sink: dict, cols):
        self._kern = kern
        self._sink = sink
        self._cols = cols

    def __getattr__(self, name):
        return getattr(self._kern, name)

    def with_noise(self, snap, tb, pt, weights, noise):
        cpu, mem, pods = self._cols
        s = self._sink
        s["pods_col"] = snap.requested[:, pods].clone()
        s["cpu_col"] = snap.requested[:, cpu].clone()
        s["mem_col"] = snap.requested[:, mem].clone()
        s["alloc_cpu_col"] = snap.allocatable[:, cpu].clone()
        s["alloc_mem_col"] = snap.allocatable[:, mem].clone()
        s["pod_tpl"] = tb.pod_tpl.clone()
        s["pod_valid"] = tb.pod_valid.clone()
        new_snap, res = self._kern.with_noise(snap, tb, pt, weights, noise)
        s["chosen"] = res.chosen.clone()
        s["placed"] = res.placed.clone()
        s["score"] = res.score.clone()
        s["feasible_tpl"] = res.feasible_tpl.clone()
        return new_snap, res


class HeldBatch:
    def __init__(self, sched, server, batch_size: int, cols):
        self._sched = sched
        self._server = server
        self._batch_size = batch_size
        self._cols = cols  # the program's (cpu, memory, pods) column indices
        self._skip: Optional[int] = None
        self._seen = 0
        self.data: Optional[dict] = None
        orig = sched._launch_wave_kernel

        def launch(kern, snap, batch, ptab, weights, noise):
            if (
                self._skip is None
                or self.data is not None
                or batch.pod_tpl.shape[0] != self._batch_size
            ):
                return orig(kern, snap, batch, ptab, weights, noise)
            self._seen += 1
            if self._seen < self._skip:
                return orig(kern, snap, batch, ptab, weights, noise)
            sink = {
                "names": list(sched.cache.encoder.row_names),
                "rv": server.resource_version,
                "t": time.monotonic(),
            }
            out = orig(_Capturing(kern, sink, self._cols), snap, batch, ptab, weights, noise)
            self.data = sink
            return out

        sched._launch_wave_kernel = launch

    def arm(self, nth: int) -> None:
        """Hold the `nth` full-size launch from now (called once the
        window has opened)."""
        self._skip = nth

    def fetch(self) -> Optional[dict]:
        """The held batch on the host (call once the window has closed)."""
        if self.data is None:
            return None
        out = {}
        for k, v in self.data.items():
            out[k] = v.cpu().numpy() if hasattr(v, "cpu") else v
        out["score"] = np.asarray(out["score"], dtype=np.float32)
        return out
