"""The traffic of a ``"loop": "closed"`` file: a backlog held at marks.

After every bind it creates measured pods until ``unbound`` of them are
unbound, then deletes the oldest bound measured pods while more than the
configuration's ``resident_measured_pods`` are bound, so every window
runs against the same state. It only calls ``APIServer.create`` and
``APIServer.delete``, on a thread of its own, and times each call into
flat arrays that the collector never walks.
"""

from __future__ import annotations

import threading
import time
from array import array


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Generator:
    def __init__(self, server, stream, pool, traffic: dict, cfg: dict,
                 namespace: str = "default", span=None):
        self._server = server
        self._stream = stream
        self._pool = pool
        self._unbound = int(traffic["unbound"])
        self._resident_max = int(cfg["resident_measured_pods"])
        self._ns = namespace
        self._span = span  # context-manager factory for the traced run
        self.created = 0
        self.deleted = 0
        # end (time.monotonic()) and length (s) of every create and delete
        self.call_t = array("d")
        self.call_s = array("d")
        self.failed = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="schedbench-generator", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._stream.wake.set()
        self._thread.join(timeout=30.0)

    def calls_between(self, t0: float, t1: float) -> list:
        """Lengths of the calls that ended between `t0` and `t1`."""
        return [s for t, s in zip(self.call_t, self.call_s) if t0 <= t <= t1]

    def _spanned(self, name: str):
        return self._span(name) if self._span is not None else _NoSpan()

    def _create(self, n: int) -> None:
        with self._spanned("schedbench.create"):
            server, pc, mono = self._server, time.perf_counter, time.monotonic
            ct, cs = self.call_t, self.call_s
            for _ in range(n):
                pod = self._pool.take()
                t0 = pc()
                server.create("pods", pod)
                t1 = pc()
                ct.append(mono())
                cs.append(t1 - t0)
                self.created += 1

    def _delete_over_mark(self) -> bool:
        if self._stream.n_bound_measured - self.deleted <= self._resident_max:
            return False
        with self._spanned("schedbench.delete"):
            s, server = self._stream, self._server
            name, pc, mono = s.names.measured, time.perf_counter, time.monotonic
            ct, cs = self.call_t, self.call_s
            while s.n_bound_measured - self.deleted > self._resident_max:
                pid = s.bound_fifo.popleft()
                t0 = pc()
                server.delete("pods", self._ns, name(pid))
                t1 = pc()
                ct.append(mono())
                cs.append(t1 - t0)
                self.deleted += 1
        return True

    def _step(self) -> bool:
        # creates first, so the queue never waits on the deletes; the
        # resident mark is restored between chunks and after the refill
        did = False
        while not self._stop.is_set():
            unbound = self.created - self._stream.n_bound_measured
            if unbound >= self._unbound:
                break
            self._create(min(self._unbound - unbound, 512))
            self._delete_over_mark()
            did = True
        return self._delete_over_mark() or did

    def _loop(self) -> None:
        wake = self._stream.wake
        while not self._stop.is_set():
            wake.clear()
            try:
                did = self._step()
            except Exception as e:  # noqa: BLE001 - reported as a failed run
                self.failed.append(repr(e))
                return
            if not did:
                wake.wait(0.05)


def make(server, stream, pool, traffic: dict, cfg: dict, span=None) -> Generator:
    return Generator(server, stream, pool, traffic, cfg, span=span)
