"""Relay publisher + fleet orchestration (the parent-process side).

``RelayPublisher`` sits next to a frontend's ``Cacher`` and bridges it
into shared memory: per kind, ONE cache watcher feeds ONE
:class:`~kubernetes_tpu.relay.ring.FrameRing`, each event's memoized
binary frame (apiserver/watchcodec.py) written exactly once. Every
relay worker process fans those bytes out to its own clients — the
frontend pays per FRAME, the workers pay per frame × their clients,
and no Python GIL is shared between the two.

``start_relay`` wires the full tier: it reserves one TCP port with
SO_REUSEPORT *without listening* (the kernel only shards accepts among
LISTENING sockets, so the parent's reservation socket receives nothing
— it just pins the port number), then spawns N worker processes
(`python -m kubernetes_tpu.relay.worker`) that bind the same port WITH
listen. Worker death sheds its accept share to the siblings instantly;
``RelayHandle.respawn_worker`` brings the count back, and the fresh
worker rebuilds the retained window from the ring floor so clients can
resume at rvs from before it existed.

The publisher's pump threads are graftlint dispatch roots (the same
never-block contract as the cacher's dispatch loop): bounded queue
gets, lock-free shared-memory writes, no sockets.
"""

from __future__ import annotations

import os
import selectors
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..apiserver import watchcodec
from ..runtime.watch import BOOKMARK
from ..utils.metrics import metrics
from .ring import FrameRing, RESYNC_TYPE

COUNTER_FRAMES = "relay_frames_published_total"        # {kind}
COUNTER_RING_EVICTIONS = "relay_ring_evictions_total"  # {kind}
COUNTER_RESYNCS = "relay_publisher_resyncs_total"      # {kind}
GAUGE_RING_FLOOR = "relay_ring_floor_rv"               # {kind}
GAUGE_RING_HEAD = "relay_ring_head_seq"                # {kind}
GAUGE_WORKERS = "relay_workers"
COUNTER_WORKER_RESTARTS = "relay_worker_restarts_total"

# ring sized for ~1 MiB of retained frames per kind by default in tests;
# the bench passes 4 MiB+ so the resume window spans whole churn storms
DEFAULT_RING_CAPACITY = 1 << 22

_PUMP_POLL_S = 0.5


class RelayPublisher:
    """One cache watcher -> one shared-memory ring, per kind."""

    def __init__(
        self,
        cacher,
        kinds: Sequence[str],
        ring_capacity: int = DEFAULT_RING_CAPACITY,
    ):
        self._cacher = cacher
        self._stop = threading.Event()
        self.rings: Dict[str, FrameRing] = {}
        self._threads: List[threading.Thread] = []
        for kind in kinds:
            ring = FrameRing.create(capacity=ring_capacity)
            self.rings[kind] = ring
            t = threading.Thread(
                target=self._pump,
                args=(kind, ring),
                name=f"relay-pub-{kind}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    # graftlint dispatch root: nothing in here may block unboundedly —
    # the ring write path is lock-free shared memory and the watcher get
    # is bounded by _PUMP_POLL_S.
    def _pump(self, kind: str, ring: FrameRing) -> None:
        w, replay_left = self._subscribe(kind, ring, initial=True)
        evicted_base = ring.floor()[0]
        while not self._stop.is_set():
            ev = w.get(timeout=_PUMP_POLL_S)
            if ev is None:
                if w.stopped and not self._stop.is_set():
                    # the publisher fell behind its own cache fan-out
                    # (queue overflow): continuity is broken, so resync —
                    # re-subscribe at the current cache rv, raise the ring
                    # floor, and tell workers to shed their clients (they
                    # resume through the cacher window / relist on 410)
                    metrics.inc(COUNTER_RESYNCS, {"kind": kind})
                    w, replay_left = self._subscribe(kind, ring, initial=False)
                continue
            if replay_left:
                # skip the rv=0 state replay: the ring carries the LIVE
                # tail only; workers serve initial state via their own
                # upstream state-sync path. The replay's closing event is
                # a bookmark at the cache rv — the ring's base position.
                replay_left -= 1
                if replay_left == 0 and ev.type == BOOKMARK:
                    ring.set_initial_floor(ev.resource_version)
                    ring.publish(
                        ev.resource_version,
                        watchcodec.bookmark_frame(ev.resource_version),
                    )
                continue
            if ev.type == BOOKMARK:
                frame = watchcodec.bookmark_frame(ev.resource_version)
            else:
                frame = watchcodec.event_frame(ev)
            ring.publish(ev.resource_version, frame)
            metrics.inc(COUNTER_FRAMES, {"kind": kind})
            floor_seq, _cum, floor_rv = ring.floor()
            if floor_seq > evicted_base:
                metrics.inc(
                    COUNTER_RING_EVICTIONS, {"kind": kind},
                    by=floor_seq - evicted_base,
                )
                evicted_base = floor_seq
            metrics.set_gauge(GAUGE_RING_FLOOR, floor_rv, {"kind": kind})
            metrics.set_gauge(GAUGE_RING_HEAD, ring.head()[0], {"kind": kind})

    def _subscribe(self, kind: str, ring: FrameRing, initial: bool):
        """(watcher, replay_left). A non-initial subscribe is a RESYNC:
        the ring gets a control record telling workers to shed clients,
        and the floor jumps to the new subscription's base rv."""
        kc = self._cacher.cache_for(kind)
        w = kc.watch(0)
        if not initial:
            base = kc.current_rv
            ring.publish(base, RESYNC_TYPE + b"")
            ring.set_initial_floor(base)
        return w, getattr(w, "replay_count", 0)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        for ring in self.rings.values():
            ring.close()

    def ring_names(self) -> Dict[str, str]:
        return {kind: ring.name for kind, ring in self.rings.items()}


class RelayHandle:
    """The running relay tier: publisher + reserved port + worker fleet."""

    def __init__(
        self,
        publisher: RelayPublisher,
        port: int,
        reserve_sock: socket.socket,
        workers: List[Tuple[subprocess.Popen, int]],
        spawn_args: List[str],
        tls: bool,
    ):
        self.publisher = publisher
        self.port = port
        self.tls = tls
        self._reserve = reserve_sock
        self.workers = workers  # [(Popen, stats_port)]
        self._spawn_args = spawn_args
        metrics.set_gauge(GAUGE_WORKERS, len(workers))

    # -- fleet management ----------------------------------------------------

    def kill_worker(self, idx: int, sig: int = 9) -> int:
        proc, _sp = self.workers[idx]
        os.kill(proc.pid, sig)
        proc.wait(timeout=10)
        return proc.pid

    def respawn_worker(self, idx: int) -> None:
        proc, stats_port = _spawn_worker(self._spawn_args)
        self.workers[idx] = (proc, stats_port)
        metrics.inc(COUNTER_WORKER_RESTARTS)
        metrics.set_gauge(GAUGE_WORKERS, len(self.workers))

    def worker_stats(self, timeout: float = 5.0) -> List[dict]:
        """Per-worker stats dicts (skips dead workers)."""
        import json
        import urllib.request

        out = []
        for proc, stats_port in self.workers:
            if proc.poll() is not None:
                continue
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{stats_port}/", timeout=timeout
                ) as resp:
                    out.append(json.loads(resp.read()))
            except OSError:
                continue
        return out

    def stop(self) -> None:
        for proc, _sp in self.workers:
            if proc.poll() is None:
                proc.terminate()
        for proc, _sp in self.workers:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        try:
            self._reserve.close()
        except OSError:
            pass
        self.publisher.stop()
        metrics.set_gauge(GAUGE_WORKERS, 0)


def _reuseport_socket(host: str, port: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    return s


def _spawn_worker(
    args: List[str], timeout: float = 60.0
) -> Tuple[subprocess.Popen, int]:
    """Start one relay worker and wait for its READY line."""
    proc = subprocess.Popen(
        args,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
    )
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    line = ""
    while time.monotonic() < deadline:
        if not sel.select(timeout=0.25):
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        break
    sel.close()
    parts = line.split()
    if len(parts) < 4 or parts[0] != "READY":
        proc.kill()
        raise RuntimeError(f"relay worker failed to start: {line!r}")
    return proc, int(parts[3])


def start_relay(
    cacher,
    sync_url: str,
    kinds: Sequence[str] = ("pods",),
    n_workers: int = 2,
    host: str = "127.0.0.1",
    port: int = 0,
    tls_cert: Optional[str] = None,
    tls_key: Optional[str] = None,
    hollow_clients: int = 0,
    hollow_kind: str = "pods",
    ring_capacity: int = DEFAULT_RING_CAPACITY,
    max_pending_bytes: int = 4 << 20,
    bookmark_period_s: float = 2.0,
) -> RelayHandle:
    """Bring up the relay tier over an existing Cacher.

    ``sync_url`` is the REST base URL (the frontend this publisher lives
    in) that workers use for rv=0 state synchronization. ``hollow_clients``
    is split evenly across workers (kubemark-style in-process watchers
    for scale benches). Returns a :class:`RelayHandle`.
    """
    publisher = RelayPublisher(cacher, kinds, ring_capacity=ring_capacity)
    reserve = _reuseport_socket(host, port)
    bound_port = reserve.getsockname()[1]
    args = [
        sys.executable, "-m", "kubernetes_tpu_torch.relay.worker",
        "--host", host,
        "--port", str(bound_port),
        "--sync-url", sync_url,
        "--max-pending-bytes", str(max_pending_bytes),
        "--bookmark-period", str(bookmark_period_s),
    ]
    for kind, name in publisher.ring_names().items():
        args += ["--ring", f"{kind}={name}"]
    if tls_cert and tls_key:
        args += ["--tls-cert", tls_cert, "--tls-key", tls_key]
    per_worker = hollow_clients // max(n_workers, 1) if hollow_clients else 0
    if per_worker:
        args += ["--hollow", str(per_worker), "--hollow-kind", hollow_kind]
    workers = []
    try:
        for _ in range(n_workers):
            workers.append(_spawn_worker(args))
    except Exception:
        for proc, _sp in workers:
            proc.kill()
        reserve.close()
        publisher.stop()
        raise
    return RelayHandle(
        publisher, bound_port, reserve, workers, args,
        tls=bool(tls_cert and tls_key),
    )


def relay_health_lines() -> List[str]:
    """Publisher/fleet counters for the SIGUSR2 serving-relay section."""
    lines: List[str] = []
    for snap in (
        metrics.snapshot_gauges("relay_"),
        metrics.snapshot_counters("relay_"),
    ):
        for name, labels, value in snap:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines
