"""Deterministic network + process fault injection for chaos tests.

The control-plane chaos suites inject faults at the store boundary
(ChaosStore) and the data-plane suites at the device boundary
(device_faults.py); this module is the NETWORK sibling — a toxiproxy-
style in-process TCP proxy that sits between REST clients and the API
server and injects the failure modes only a real deployment sees:

  * **latency / jitter / bandwidth caps** (``set_latency`` /
    ``set_bandwidth``): per-chunk shaping on both directions — the slow-
    network soak regime where every request still succeeds, eventually;
  * **mid-request connection resets** (``reset_next_requests``): the
    client's request head is read, then the connection is RST before
    anything reaches the server — the request was provably NOT applied;
  * **response blackholes** (``blackhole_next_responses``): the request
    is forwarded and processed upstream, the RESPONSE is discarded and
    the client leg reset — the write APPLIED, the ack was lost. The
    unknown-outcome case the PR-3 read-back reconciler exists for;
  * **full partitions** (``partition``): ``refuse`` closes the listener
    (fast ECONNREFUSED — the request never left the client) and severs
    live flows with RST; ``drop`` silently stops forwarding so both
    sides hang until their own timeouts, like real packet loss;
  * **half-open streams** (``half_open_upstream``): the server-facing
    leg is severed with RST while the client leg stays open and silent —
    from the server's side the client vanished without FIN, exactly the
    half-open TCP shape the watch bookmark heartbeat must reap.

Everything is armed-counter indexed (consumed in connection-accept
order) with an optional request-head ``match`` — never random. A chaos
scenario is a statement, not a dice roll. Deterministic jitter comes
from a fixed LCG sequence.

Process-chaos helpers (``sigstop``/``sigcont``/``sigkill``) ride along:
a SIGSTOP'd scheduler is the canonical zombie ex-leader — frozen through
its lease expiry, resumed with a stale fence.

Import-light on purpose (stdlib + utils.metrics, NO jax): the proxy runs
in tier-1 tests and in child processes that never touch a device.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional

from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.testing.netchaos")

# TCP connections accepted by the proxy (one REST request each for the
# keep-alive-free urllib client; watch streams hold one for their life)
COUNTER_CONNECTIONS = "netchaos_connections_total"
# injected faults by kind: reset, blackhole, partition_refuse,
# partition_drop, partition_parked, half_open
COUNTER_FAULTS = "netchaos_injected_faults_total"  # {kind}
# bytes relayed per direction (up = client->server, down = server->client)
COUNTER_BYTES = "netchaos_bytes_total"  # {direction}

_CHUNK = 65536


def _rst_close(sock: Optional[socket.socket]) -> None:
    """Sever a connection abruptly. SO_LINGER(1,0) + close sends RST when
    this thread owns the socket; the shutdown in between is load-bearing
    for the CROSS-THREAD case — a close() while another thread is blocked
    in recv() on the same fd leaves the kernel socket alive (the in-flight
    syscall holds a file reference) and the peer would never see the
    connection die at all. shutdown() tears the connection down at the
    kernel level immediately (the peer sees FIN/RST and any blocked recv
    wakes), close then releases the fd."""
    if sock is None:
        return
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _quiet_close(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.close()
    except OSError:
        pass


def _close_listener(lst: Optional[socket.socket]) -> None:
    """Close a LISTENING socket so the port actually refuses. A plain
    close() while another thread is blocked in accept() leaves the
    kernel socket alive (the in-flight syscall holds a file reference)
    and the port keeps completing handshakes into the backlog; shutdown
    first wakes the blocked accept and drops the listen queue."""
    if lst is None:
        return
    try:
        lst.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    _quiet_close(lst)


class _ArmedFault:
    """One armed fault: consumed by the first matching connection."""

    def __init__(self, kind: str, match: Optional[bytes]):
        self.kind = kind
        self.match = match

    def matches(self, head: bytes) -> bool:
        return self.match is None or self.match in head


class _Pair:
    """One client<->upstream connection pair."""

    def __init__(self, client: socket.socket, upstream: socket.socket,
                 blackhole_down: bool):
        self.client = client
        self.upstream = upstream
        self.blackhole_down = blackhole_down
        self.stale = False  # severed by partition/half-open: pumps bail
        self._pumps_left = 2
        self._lock = threading.Lock()

    def pump_done(self) -> None:
        with self._lock:
            self._pumps_left -= 1
            last = self._pumps_left == 0
        if last:
            _quiet_close(self.client)
            _quiet_close(self.upstream)


class NetChaosProxy:
    """Deterministic TCP proxy between a REST client and the API server.

    Usage::

        proxy = NetChaosProxy("127.0.0.1", api_port)
        proxy.start()
        client = RESTClient(f"http://127.0.0.1:{proxy.port}")
        proxy.blackhole_next_responses(1, match=b"/binding")
        ...
        proxy.stop()
    """

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        listen_host: str = "127.0.0.1",
    ):
        self.upstream_host = upstream_host
        self.upstream_port = upstream_port
        self.listen_host = listen_host
        self.port: int = 0
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pairs: List[_Pair] = []
        self._parked: List[socket.socket] = []  # partition(drop) arrivals
        self._half_open_clients: List[socket.socket] = []
        self._faults: deque = deque()  # armed _ArmedFaults, FIFO
        self._latency_s = 0.0
        self._jitter_s = 0.0
        self._bandwidth_bps: Optional[float] = None
        self._partitioned: Optional[str] = None  # None | "refuse" | "drop"
        self._jitter_state = 0x9E3779B9  # fixed LCG seed: deterministic
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "NetChaosProxy":
        self._bind_listener()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="netchaos-accept"
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            lst, self._listener = self._listener, None
            pairs = list(self._pairs)
            parked = list(self._parked)
            half = list(self._half_open_clients)
            self._pairs.clear()
            self._parked.clear()
            self._half_open_clients.clear()
        _close_listener(lst)
        for p in pairs:
            _rst_close(p.client)
            _rst_close(p.upstream)
        for s in parked + half:
            _rst_close(s)

    def _bind_listener(self) -> None:
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self.listen_host, self.port))
        lst.listen(128)
        self.port = lst.getsockname()[1]
        self._listener = lst

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            lst = self._listener
            if lst is None:  # partition(refuse): port answers ECONNREFUSED
                time.sleep(0.02)
                continue
            try:
                client, _ = lst.accept()
            except OSError:
                continue  # listener closed under us (partition/stop)
            threading.Thread(
                target=self._serve_conn,
                args=(client,),
                daemon=True,
                name="netchaos-conn",
            ).start()

    # -- fault knobs ---------------------------------------------------------

    def set_latency(self, latency_s: float, jitter_s: float = 0.0) -> None:
        """Per-chunk one-way latency (+deterministic jitter in
        [-jitter_s, +jitter_s] from a fixed LCG sequence)."""
        with self._lock:
            self._latency_s = latency_s
            self._jitter_s = jitter_s

    def set_bandwidth(self, bytes_per_s: Optional[float]) -> None:
        """Cap relay throughput (None = unlimited)."""
        with self._lock:
            self._bandwidth_bps = bytes_per_s

    def reset_next_requests(
        self, n: int = 1, match: Optional[bytes] = None
    ) -> None:
        """RST the next n (matching) connections after reading the
        request head and BEFORE forwarding anything: the request provably
        never reached the server."""
        with self._lock:
            for _ in range(n):
                self._faults.append(_ArmedFault("reset", match))

    def blackhole_next_responses(
        self, n: int = 1, match: Optional[bytes] = None
    ) -> None:
        """Forward the next n (matching) requests upstream, DISCARD the
        responses, and RST the client leg: write applied, ack lost — the
        unknown-outcome case."""
        with self._lock:
            for _ in range(n):
                self._faults.append(_ArmedFault("blackhole", match))

    def clear_faults(self) -> int:
        """Disarm every armed (unconsumed) reset/blackhole fault; returns
        how many were still pending. The heal knob for bind-path-only
        fault storms (arm N resets, let the reconciler spin, clear)."""
        with self._lock:
            n = len(self._faults)
            self._faults.clear()
            return n

    def partition(self, mode: str = "refuse") -> None:
        """Sever the proxy path. ``refuse``: the listener closes (new
        connects get ECONNREFUSED instantly — the request never left the
        client) and live flows are RST. ``drop``: the listener keeps
        accepting but nothing is ever answered and live flows silently
        stop forwarding — both sides hang until their own timeouts, like
        real packet loss. heal() restores the path on the SAME port."""
        if mode not in ("refuse", "drop"):
            raise ValueError(f"unknown partition mode {mode!r}")
        metrics.inc(COUNTER_FAULTS, {"kind": f"partition_{mode}"})
        with self._lock:
            self._partitioned = mode
            pairs = list(self._pairs)
            lst = None
            if mode == "refuse":
                lst, self._listener = self._listener, None
            for p in pairs:
                p.stale = True
        _close_listener(lst)
        if mode == "refuse":
            for p in pairs:
                _rst_close(p.client)
                _rst_close(p.upstream)

    def heal(self) -> None:
        """Restore the path. Connections that spanned the partition get
        RST (a real heal finds the peer's TCP state gone); parked
        connections are released the same way so blocked clients error
        out now instead of at their timeout."""
        with self._lock:
            mode, self._partitioned = self._partitioned, None
            stale = [p for p in self._pairs if p.stale]
            self._pairs = [p for p in self._pairs if not p.stale]
            parked, self._parked = self._parked, []
            need_listener = self._listener is None and not self._stop.is_set()
        for p in stale:
            _rst_close(p.client)
            _rst_close(p.upstream)
        for s in parked:
            _rst_close(s)
        if need_listener:
            self._bind_listener()
        if mode:
            logger.info("netchaos: healed %s partition on :%d", mode, self.port)

    def half_open_upstream(self) -> int:
        """Sever every live upstream leg with RST while keeping the
        client legs open and silent: the server sees a vanished peer
        (next write fails — what the bookmark heartbeat reaper detects),
        the client sees a half-open stream. Returns severed count."""
        with self._lock:
            pairs = [p for p in self._pairs if not p.stale]
            for p in pairs:
                p.stale = True
                self._half_open_clients.append(p.client)
            self._pairs = [p for p in self._pairs if p not in pairs]
        for p in pairs:
            _rst_close(p.upstream)
            metrics.inc(COUNTER_FAULTS, {"kind": "half_open"})
        return len(pairs)

    def kill_connections(self) -> int:
        """RST both legs of every live pair (crash-shaped disconnect)."""
        with self._lock:
            pairs, self._pairs = self._pairs, []
        for p in pairs:
            p.stale = True
            _rst_close(p.client)
            _rst_close(p.upstream)
        return len(pairs)

    def live_connections(self) -> int:
        with self._lock:
            return len([p for p in self._pairs if not p.stale])

    # -- internals -----------------------------------------------------------

    def _take_fault(self, head: bytes) -> Optional[str]:
        with self._lock:
            for f in list(self._faults):
                if f.matches(head):
                    self._faults.remove(f)
                    return f.kind
        return None

    def _next_jitter(self) -> float:
        """Deterministic jitter in [-jitter_s, +jitter_s]: a fixed 32-bit
        LCG, never wall-clock or random — reruns shape identically."""
        with self._lock:
            self._jitter_state = (
                self._jitter_state * 1664525 + 1013904223
            ) & 0xFFFFFFFF
            unit = self._jitter_state / 0xFFFFFFFF  # [0, 1]
            return (unit * 2.0 - 1.0) * self._jitter_s

    def _shape(self, n_bytes: int) -> None:
        with self._lock:
            latency = self._latency_s
            bw = self._bandwidth_bps
        delay = 0.0
        if latency > 0.0:
            delay += max(0.0, latency + self._next_jitter())
        if bw:
            delay += n_bytes / bw
        if delay > 0.0:
            time.sleep(delay)

    def _serve_conn(self, client: socket.socket) -> None:
        metrics.inc(COUNTER_CONNECTIONS)
        if self._partitioned == "drop":
            # packet-loss partition: the connect succeeded (SYN queue)
            # but nothing is ever answered — park until heal/stop
            metrics.inc(COUNTER_FAULTS, {"kind": "partition_parked"})
            with self._lock:
                self._parked.append(client)
            return
        try:
            head = client.recv(_CHUNK)
        except OSError:
            _quiet_close(client)
            return
        if not head:
            _quiet_close(client)
            return
        fault = self._take_fault(head)
        if fault == "reset":
            # mid-request reset: nothing was forwarded — the server never
            # saw this request
            metrics.inc(COUNTER_FAULTS, {"kind": "reset"})
            _rst_close(client)
            return
        try:
            upstream = socket.create_connection(
                (self.upstream_host, self.upstream_port), timeout=5.0
            )
        except OSError:
            _rst_close(client)
            return
        if fault == "blackhole":
            metrics.inc(COUNTER_FAULTS, {"kind": "blackhole"})
        pair = _Pair(client, upstream, blackhole_down=(fault == "blackhole"))
        with self._lock:
            if self._stop.is_set():
                pass  # closed below by the pumps exiting immediately
            self._pairs.append(pair)
        metrics.inc(COUNTER_BYTES, {"direction": "up"}, by=float(len(head)))
        self._shape(len(head))
        try:
            upstream.sendall(head)
        except OSError:
            pair.stale = True
        threading.Thread(
            target=self._pump, args=(pair, "up"), daemon=True,
            name="netchaos-up",
        ).start()
        threading.Thread(
            target=self._pump, args=(pair, "down"), daemon=True,
            name="netchaos-down",
        ).start()

    @staticmethod
    def _looks_like_request_head(chunk: bytes) -> bool:
        return chunk.split(b" ", 1)[0] in (
            b"GET", b"POST", b"PUT", b"DELETE", b"HEAD", b"PATCH",
        )

    def _pump(self, pair: _Pair, direction: str) -> None:
        src = pair.client if direction == "up" else pair.upstream
        dst = pair.upstream if direction == "up" else pair.client
        try:
            while not self._stop.is_set() and not pair.stale:
                try:
                    chunk = src.recv(_CHUNK)
                except OSError:
                    break
                if not chunk:
                    break
                if self._partitioned or pair.stale:
                    # partition landed while we were blocked in recv:
                    # silently drop the data — both sides now hang
                    return  # pair closed by heal()/stop()
                if (
                    direction == "up"
                    and self._faults
                    and self._looks_like_request_head(chunk)
                ):
                    # keep-alive clients carry MANY requests per
                    # connection: armed faults must match each request
                    # head, not just the connection's first (accept-time)
                    # one. A body-continuation chunk never starts with a
                    # method verb and is skipped.
                    fault = self._take_fault(chunk)
                    if fault == "reset":
                        # dropped BEFORE forwarding: the server never saw
                        # this request (the client, on its reused socket,
                        # cannot know that — honest classification there
                        # is unknown-outcome)
                        metrics.inc(COUNTER_FAULTS, {"kind": "reset"})
                        self._terminate_pair(pair)
                        return
                    if fault == "blackhole":
                        metrics.inc(COUNTER_FAULTS, {"kind": "blackhole"})
                        pair.blackhole_down = True
                metrics.inc(
                    COUNTER_BYTES, {"direction": direction},
                    by=float(len(chunk)),
                )
                self._shape(len(chunk))
                if direction == "down" and pair.blackhole_down:
                    # response discarded: write applied, ack lost. The
                    # pair dies NOW — a keep-alive upstream never EOFs on
                    # its own, and the client must see a dead connection,
                    # not a stall
                    self._terminate_pair(pair)
                    return
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
        finally:
            if pair.stale or self._partitioned:
                return  # sockets are owned by heal()/stop() now
            if direction == "down" and pair.blackhole_down:
                # response fully swallowed: the ack is LOST, not late —
                # the client must see a dead connection, not a clean EOF
                # it could mistake for a framed empty response
                _rst_close(pair.client)
            else:
                try:
                    dst.shutdown(socket.SHUT_WR)  # relay the EOF
                except OSError:
                    pass
            pair.pump_done()
            with self._lock:
                if pair in self._pairs and pair._pumps_left == 0:
                    self._pairs.remove(pair)

    def _terminate_pair(self, pair: _Pair) -> None:
        """RST both legs of a pair from inside a pump (injected fault).
        Marking the pair stale FIRST makes both pumps' cleanup paths
        stand down (stale = sockets owned elsewhere — here): the sibling
        wakes on its dead socket and simply exits."""
        pair.stale = True
        _rst_close(pair.client)
        _rst_close(pair.upstream)
        with self._lock:
            if pair in self._pairs:
                self._pairs.remove(pair)


# -- load balancer: the proxy machinery run in reverse -----------------------

# client connections relayed per backend, and backends skipped because a
# connect failed (the backend is cooling down / dead)
COUNTER_BALANCER_CONNS = "netchaos_balancer_connections_total"  # {backend}
COUNTER_BALANCER_SKIPS = "netchaos_balancer_backend_skips_total"  # {backend}


class LoadBalancerProxy:
    """One listener, N upstream backends: the serving-tier balancer.

    The same accept/pump machinery as :class:`NetChaosProxy`, inverted —
    instead of one upstream with injected faults, each accepted client
    connection is relayed verbatim to a backend chosen by policy:

      * ``round_robin``: rotate through the backend list;
      * ``least_conn`` (default): the backend with the fewest live
        relayed connections — watch streams hold their connection for
        life, so connection count is the honest load signal for a mixed
        request/stream fleet.

    A backend whose connect fails is put on a cooldown
    (``retry_cooldown_s``) and the next candidate is tried in the same
    accept — a killed frontend drains out of rotation within one failed
    connect, and its in-flight streams RST so clients resume (the
    RESTClient watch pump reconnects through the balancer and lands on a
    healthy sibling, whose watch cache replays the gap).

    Deliberately a dumb L4 relay: HTTP keep-alive, chunked watch
    streams, and the binary watch codec all pass through untouched.
    """

    def __init__(
        self,
        backends: List[Tuple[str, int]],
        listen_host: str = "127.0.0.1",
        policy: str = "least_conn",
        retry_cooldown_s: float = 1.0,
        connect_timeout_s: float = 2.0,
    ):
        if policy not in ("round_robin", "least_conn"):
            raise ValueError(f"unknown balance policy {policy!r}")
        self.backends = [tuple(b) for b in backends]
        self.listen_host = listen_host
        self.policy = policy
        self.retry_cooldown_s = retry_cooldown_s
        self.connect_timeout_s = connect_timeout_s
        self.port: int = 0
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pairs: List[tuple] = []  # (backend, _Pair)
        self._cooldown: dict = {}  # backend -> monotonic deadline
        self._rr = 0

    def start(self) -> "LoadBalancerProxy":
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self.listen_host, self.port))
        lst.listen(512)
        self.port = lst.getsockname()[1]
        self._listener = lst
        threading.Thread(
            target=self._accept_loop, daemon=True, name="lb-accept"
        ).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            lst, self._listener = self._listener, None
            pairs = [p for _b, p in self._pairs]
            self._pairs.clear()
        _close_listener(lst)
        for p in pairs:
            _rst_close(p.client)
            _rst_close(p.upstream)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            lst = self._listener
            if lst is None:
                return
            try:
                client, _ = lst.accept()
            except OSError:
                continue
            threading.Thread(
                target=self._serve_conn, args=(client,), daemon=True,
                name="lb-conn",
            ).start()

    def _candidates(self) -> List[Tuple[str, int]]:
        """Backends in try-order for one accept, cooled-down ones last
        (still tried: with every backend cooling, a liveness probe beats
        refusing service)."""
        now = time.monotonic()
        with self._lock:
            live = [
                (b, sum(1 for bb, p in self._pairs if bb == b))
                for b in self.backends
            ]
            if self.policy == "round_robin":
                self._rr += 1
                n = len(self.backends)
                order = [live[(self._rr + i) % n][0] for i in range(n)]
            else:
                order = [b for b, _cnt in sorted(live, key=lambda x: x[1])]
            cooling = {
                b for b, dl in self._cooldown.items() if dl > now
            }
        return [b for b in order if b not in cooling] + [
            b for b in order if b in cooling
        ]

    def _serve_conn(self, client: socket.socket) -> None:
        for backend in self._candidates():
            try:
                upstream = socket.create_connection(
                    backend, timeout=self.connect_timeout_s
                )
            except OSError:
                metrics.inc(
                    COUNTER_BALANCER_SKIPS,
                    {"backend": f"{backend[0]}:{backend[1]}"},
                )
                with self._lock:
                    self._cooldown[backend] = (
                        time.monotonic() + self.retry_cooldown_s
                    )
                continue
            upstream.settimeout(None)
            metrics.inc(
                COUNTER_BALANCER_CONNS,
                {"backend": f"{backend[0]}:{backend[1]}"},
            )
            with self._lock:
                self._cooldown.pop(backend, None)
            pair = _Pair(client, upstream, blackhole_down=False)
            with self._lock:
                self._pairs.append((backend, pair))
            threading.Thread(
                target=self._pump, args=(pair, "up"), daemon=True,
                name="lb-up",
            ).start()
            threading.Thread(
                target=self._pump, args=(pair, "down"), daemon=True,
                name="lb-down",
            ).start()
            return
        _rst_close(client)  # every backend down: fail fast, not hang

    def _pump(self, pair: _Pair, direction: str) -> None:
        src = pair.client if direction == "up" else pair.upstream
        dst = pair.upstream if direction == "up" else pair.client
        try:
            while not self._stop.is_set():
                try:
                    chunk = src.recv(_CHUNK)
                except OSError:
                    break
                if not chunk:
                    break
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)  # relay the EOF
            except OSError:
                pass
            pair.pump_done()
            with self._lock:
                self._pairs = [
                    (b, p)
                    for b, p in self._pairs
                    if not (p is pair and p._pumps_left == 0)
                ]

    def live_connections(self) -> int:
        with self._lock:
            return len(self._pairs)

    def connections_per_backend(self) -> dict:
        with self._lock:
            out: dict = {}
            for b, _p in self._pairs:
                out[b] = out.get(b, 0) + 1
            return out


# -- process chaos -----------------------------------------------------------


def _pid_of(proc) -> int:
    return proc if isinstance(proc, int) else proc.pid


def sigstop(proc) -> None:
    """Freeze a process (SIGSTOP): the zombie-maker. A stopped scheduler
    keeps its lease token but cannot renew; resumed after the standby
    promoted, its late binds carry a stale fence."""
    os.kill(_pid_of(proc), signal.SIGSTOP)


def sigcont(proc) -> None:
    """Resume a SIGSTOP'd process: the zombie walks."""
    os.kill(_pid_of(proc), signal.SIGCONT)


def sigkill(proc) -> None:
    """Hard-kill (SIGKILL): no release, no cleanup — the crash shape."""
    os.kill(_pid_of(proc), signal.SIGKILL)
