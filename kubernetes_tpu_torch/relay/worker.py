"""Relay worker: SO_REUSEPORT accept sharding + batched frame fan-out.

One worker process owns the clients it accepted and nothing else. The
kernel shards accepts across the N workers listening on the shared
port (SO_REUSEPORT); each worker polls the shared-memory frame rings
and fans a new frame out to every subscribed client with batched
non-blocking ``socket.sendmsg`` (scatter-gather writev) — one wire
chunk is built per frame per worker and SHARED across all client send
queues, so per-frame cost is O(clients) pointer appends plus the
syscalls, never O(clients) encodes.

Never-block discipline (graftlint dispatch root ``RelayWorker._dispatch``,
the same contract the cacher's dispatch thread lives under):

  * sends are non-blocking; a would-block registers the fd for
    writability and moves on,
  * a client whose pending buffer exceeds the bound is a SLOW CLIENT
    and is evicted on the spot (it reconnects and resumes through the
    cacher-window contract — or relists on 410),
  * accepts, TLS handshakes, HTTP parsing, and rv=0 state sync all live
    on intake threads, never in the dispatch loop.

Death is invisible to informers: the ring outlives the worker, a
replacement reader starts at the ring FLOOR and rebuilds the retained
window, and clients that reconnect mid-gap resume at their last
delivered rv (or 410 into a relist, exactly like the cacher window).
"""

from __future__ import annotations

import argparse
import json
import os
import selectors
import socket
import ssl
import struct
import sys
import threading
import time
from array import array
from collections import deque
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from ..apiserver.watchcodec import WATCH_CONTENT_TYPE, bookmark_frame
from .ring import BOOKMARK_TYPE, FrameRing, PAD, RESYNC_TYPE, RingReader

_EVENT_TYPES = (b"A", b"M", b"D", b"J")
_FRAME_HDR = struct.Struct(">cI")

# sendmsg is capped at IOV_MAX buffers per call; stay far below it
_SENDMSG_BATCH = 64
_INTAKE_TIMEOUT_S = 15.0
_POLL_BUSY_S = 0.002
_POLL_IDLE_S = 0.02


def _chunk(frame: bytes) -> bytes:
    """HTTP/1.1 chunked wire form, built once per frame per worker."""
    return b"%x\r\n%s\r\n" % (len(frame), frame)


class _Client:
    __slots__ = (
        "sock", "fd", "kind", "resume_rv", "pending", "pending_bytes",
        "tls", "wregistered",
    )

    def __init__(self, sock, kind: str, resume_rv: int, tls: bool):
        self.sock = sock
        self.fd = sock.fileno()
        self.kind = kind
        self.resume_rv = resume_rv
        self.pending: deque = deque()
        self.pending_bytes = 0
        self.tls = tls
        self.wregistered = False

    def queue(self, wire: bytes) -> None:
        self.pending.append(wire)
        self.pending_bytes += len(wire)


class _KindState:
    __slots__ = (
        "kind", "ring", "reader", "history", "clients", "last_rv",
        "last_frame_t", "hollow_delivered", "hollow_rv",
    )

    def __init__(self, kind: str, ring: FrameRing, hollow: int):
        self.kind = kind
        self.ring = ring
        self.reader = RingReader(ring)  # from the floor: full window
        # (rv, ftype, wire) of retained frames for resume replay
        self.history: deque = deque()
        self.clients: List[_Client] = []
        self.last_rv = ring.floor_rv()
        self.last_frame_t = time.monotonic()
        # kubemark-style hollow watchers: per-client delivered counters
        # and rv cursors keep the per-client fan-out work REAL (one
        # filter + one bump per client per frame) without sockets
        self.hollow_delivered = array("Q", [0] * hollow) if hollow else None
        self.hollow_rv = (
            array("Q", [self.last_rv] * hollow) if hollow else None
        )


class RelayWorker:
    def __init__(
        self,
        host: str,
        port: int,
        rings: Dict[str, str],
        sync_url: str,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        hollow: int = 0,
        hollow_kind: str = "pods",
        max_pending_bytes: int = 4 << 20,
        bookmark_period_s: float = 2.0,
    ):
        self.sync_url = sync_url
        self.max_pending_bytes = max_pending_bytes
        self.bookmark_period_s = bookmark_period_s
        self._stop = threading.Event()
        self._incoming: deque = deque()  # intake -> dispatch handoff
        self._sel = selectors.DefaultSelector()
        self._kinds: Dict[str, _KindState] = {}
        for kind, shm_name in rings.items():
            n_hollow = hollow if kind == hollow_kind else 0
            self._kinds[kind] = _KindState(
                kind, FrameRing.attach(shm_name), n_hollow
            )
        self._ssl_ctx = None
        if tls_cert and tls_key:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._ssl_ctx = ctx
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._listener.bind((host, port))
        self._listener.listen(1024)
        self.port = self._listener.getsockname()[1]
        # counters (dispatch-thread writes, stats-thread reads: benign)
        self.frames_seen = 0
        self.real_delivered = 0
        self.hollow_delivered_total = 0
        self.evicted_slow = 0
        self.disconnects = 0
        self.shed = 0
        self.sync_streams = 0
        self.n_clients = 0

    # -- intake side (blocking is fine here: never on the dispatch path) -----

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: shutting down
            t = threading.Thread(
                target=self._handle_intake, args=(conn,),
                name="relay-intake", daemon=True,
            )
            t.start()

    def _handle_intake(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(_INTAKE_TIMEOUT_S)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # cap the kernel send buffer: autotuning would grow it to
            # ~4 MiB per deaf client, hiding that much fan-out behind
            # the OS before max_pending_bytes could ever trip — the
            # per-client memory bound must be OURS, not the autotuner's
            conn.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF,
                min(self.max_pending_bytes, 128 << 10),
            )
            if self._ssl_ctx is not None:
                conn = self._ssl_ctx.wrap_socket(conn, server_side=True)
            kind, from_rv = self._read_request(conn)
            st = self._kinds.get(kind)
            if st is None:
                self._reject(conn, 404, f"no relay ring for kind {kind}")
                return
            if from_rv and from_rv < st.ring.floor_rv():
                self._reject(
                    conn, 410,
                    f"resourceVersion {from_rv} is too old for the relay "
                    f"ring (floor {st.ring.floor_rv()})",
                )
                return
            conn.sendall(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: " + WATCH_CONTENT_TYPE.encode() + b"\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"
            )
            if not from_rv:
                # rv=0: replay current state from the frontend (one
                # upstream watch, forwarded verbatim up to its closing
                # bookmark), then ride the ring from the bookmark rv
                from_rv = self._state_sync(conn, kind)
            conn.settimeout(0)  # non-blocking from here: dispatch owns it
            self._incoming.append(
                _Client(conn, kind, from_rv, tls=self._ssl_ctx is not None)
            )
        except (OSError, ValueError, ssl.SSLError):
            try:
                conn.close()
            except OSError:
                pass

    def _read_request(self, conn) -> (str, int):
        f = conn.makefile("rb")
        try:
            reqline = f.readline(4096).decode("latin-1").strip()
            while True:
                line = f.readline(4096)
                if not line or line in (b"\r\n", b"\n"):
                    break
            parts = reqline.split()
            if len(parts) != 3 or parts[0] != "GET":
                raise ValueError(f"bad relay request: {reqline!r}")
            split = urlsplit(parts[1])
            q = parse_qs(split.query)
            if q.get("watch", ["0"])[-1] not in ("1", "true"):
                raise ValueError("relay serves watches only")
            kind = split.path.rstrip("/").rsplit("/", 1)[-1]
            from_rv = int(q.get("resourceVersion", ["0"])[-1] or 0)
            return kind, from_rv
        finally:
            f.close()

    def _reject(self, conn, status: int, body: str) -> None:
        reason = {404: "Not Found", 410: "Gone"}.get(status, "Bad Request")
        payload = body.encode()
        conn.sendall(
            b"HTTP/1.1 %d %s\r\nContent-Type: text/plain\r\n"
            b"Content-Length: %d\r\nConnection: close\r\n\r\n%s"
            % (status, reason.encode(), len(payload), payload)
        )
        conn.close()

    def _state_sync(self, conn, kind: str) -> int:
        """Forward the upstream rv=0 state replay (ADDED per object +
        the closing bookmark) verbatim, returning the bookmark rv."""
        import http.client

        self.sync_streams += 1
        sp = urlsplit(self.sync_url)
        if sp.scheme == "https":
            up = http.client.HTTPSConnection(
                sp.hostname, sp.port or 443, timeout=_INTAKE_TIMEOUT_S,
                context=ssl._create_unverified_context(),
            )
        else:
            up = http.client.HTTPConnection(
                sp.hostname, sp.port or 80, timeout=_INTAKE_TIMEOUT_S
            )
        try:
            up.request(
                "GET", f"/api/v1/{kind}?watch=1&resourceVersion=0",
                headers={"Accept": WATCH_CONTENT_TYPE},
            )
            resp = up.getresponse()
            if resp.status != 200:
                raise OSError(f"state sync failed: HTTP {resp.status}")
            while True:
                head = resp.read(_FRAME_HDR.size)
                if len(head) < _FRAME_HDR.size:
                    raise OSError("state sync stream truncated")
                code, length = _FRAME_HDR.unpack(head)
                payload = resp.read(length)
                if len(payload) < length:
                    raise OSError("state sync stream truncated")
                conn.sendall(_chunk(head + payload))
                if code == BOOKMARK_TYPE:
                    return struct.unpack(">Q", payload)[0]
        finally:
            up.close()

    # -- dispatch side (graftlint dispatch root: never block) ----------------

    def _dispatch(self) -> None:
        states = list(self._kinds.values())
        while not self._stop.is_set():
            now = time.monotonic()
            self._drain_incoming()
            progressed = False
            for st in states:
                frames, lapped = st.reader.read_new()
                if lapped:
                    # the dispatch loop itself fell a full ring behind:
                    # every client of the kind is gapped — shed them all
                    self._shed_kind(st)
                if frames:
                    progressed = True
                    st.last_frame_t = now
                    for _seq, rv, ftype, frame in frames:
                        self._fan_out(st, rv, ftype, frame)
            for st in states:
                if now - st.last_frame_t >= self.bookmark_period_s:
                    # ring idle (degraded primary / stalled publisher):
                    # per-stream heartbeats keep informer resume
                    # positions fresh from the worker alone
                    st.last_frame_t = now
                    if st.clients:
                        wire = _chunk(bookmark_frame(st.last_rv))
                        for c in st.clients:
                            c.queue(wire)
                # copy: a write failure inside _try_flush drops the
                # client from st.clients mid-iteration
                for c in list(st.clients):
                    if c.pending:
                        self._try_flush(st, c)
            self._sel.select(
                timeout=_POLL_BUSY_S if progressed else _POLL_IDLE_S
            )

    def _drain_incoming(self) -> None:
        while True:
            try:
                c = self._incoming.popleft()
            except IndexError:
                return
            st = self._kinds[c.kind]
            if c.resume_rv and c.resume_rv < st.ring.floor_rv():
                # floor advanced between intake and registration: the
                # stream is gapped before it started — close it; the
                # reconnect gets a clean 410 from intake
                self._drop(st, c, counted=False)
                continue
            # replay the retained window above the client's position,
            # then a bookmark advancing it to the kind's current rv
            for rv, ftype, wire in st.history:
                if ftype in _EVENT_TYPES and rv > c.resume_rv:
                    c.queue(wire)
            c.queue(_chunk(bookmark_frame(max(st.last_rv, c.resume_rv))))
            st.clients.append(c)
            self.n_clients += 1
            self._try_flush(st, c)

    def _fan_out(self, st: _KindState, rv: int, ftype: bytes,
                 frame: bytes) -> None:
        if ftype == RESYNC_TYPE:
            # publisher lost continuity: every client must resume
            # through the cacher window instead of trusting the ring
            self._shed_kind(st)
            return
        self.frames_seen += 1
        wire = _chunk(frame)
        st.history.append((rv, ftype, wire))
        floor_rv = st.ring.floor_rv()
        while st.history and st.history[0][0] < floor_rv:
            st.history.popleft()
        if ftype != BOOKMARK_TYPE:
            if rv > st.last_rv:
                st.last_rv = rv
        hd = st.hollow_delivered
        if hd is not None:
            # the hollow fleet's per-client work is real: one rv-filter
            # check + one counter bump per client per frame
            if ftype == BOOKMARK_TYPE:
                for i in range(len(hd)):
                    hd[i] += 1
                self.hollow_delivered_total += len(hd)
            else:
                hrv = st.hollow_rv
                n = 0
                for i in range(len(hd)):
                    if rv > hrv[i]:
                        hd[i] += 1
                        hrv[i] = rv
                        n += 1
                self.hollow_delivered_total += n
        if st.clients:
            slow = None
            for c in st.clients:
                c.queue(wire)
                if c.pending_bytes > self.max_pending_bytes:
                    if slow is None:
                        slow = []
                    slow.append(c)
            self.real_delivered += len(st.clients)
            if slow:
                for c in slow:
                    self.evicted_slow += 1
                    self._drop(st, c)

    def _try_flush(self, st: _KindState, c: _Client) -> None:
        sock = c.sock
        try:
            while c.pending:
                if c.tls:
                    n = sock.send(c.pending[0])
                else:
                    bufs = []
                    for i, b in enumerate(c.pending):
                        if i >= _SENDMSG_BATCH:
                            break
                        bufs.append(b)
                    n = sock.sendmsg(bufs)
                c.pending_bytes -= n
                while n:
                    head = c.pending[0]
                    if n >= len(head):
                        n -= len(head)
                        c.pending.popleft()
                    else:
                        c.pending[0] = head[n:]
                        n = 0
        except (BlockingIOError, ssl.SSLWantWriteError, ssl.SSLWantReadError):
            if not c.wregistered:
                try:
                    self._sel.register(c.fd, selectors.EVENT_WRITE, c)
                    c.wregistered = True
                except (KeyError, ValueError, OSError):
                    pass
            return
        except OSError:
            # abrupt disconnect: detected AT the write-failure site —
            # account for the stream immediately, never at the next tick
            self.disconnects += 1
            self._drop(st, c)
            return
        if c.wregistered:
            try:
                self._sel.unregister(c.fd)
            except (KeyError, ValueError, OSError):
                pass
            c.wregistered = False

    def _drop(self, st: _KindState, c: _Client, counted: bool = True) -> None:
        if c.wregistered:
            try:
                self._sel.unregister(c.fd)
            except (KeyError, ValueError, OSError):
                pass
            c.wregistered = False
        try:
            c.sock.close()
        except OSError:
            pass
        try:
            st.clients.remove(c)
            if counted:
                self.n_clients -= 1
        except ValueError:
            pass  # never registered (pre-registration close)

    def _shed_kind(self, st: _KindState) -> None:
        for c in list(st.clients):
            self.shed += 1
            self._drop(st, c)
        st.history.clear()
        st.last_rv = max(st.last_rv, st.ring.floor_rv())

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> dict:
        t = os.times()
        per_kind = {}
        n_hollow = 0
        for kind, st in self._kinds.items():
            hollow = len(st.hollow_delivered) if st.hollow_delivered else 0
            n_hollow += hollow
            per_kind[kind] = {
                "last_rv": st.last_rv,
                "floor_rv": st.ring.floor_rv(),
                "history": len(st.history),
                "clients": len(st.clients),
                "hollow": hollow,
                "lapped": st.reader.lapped_total,
            }
        return {
            "pid": os.getpid(),
            "port": self.port,
            "clients": self.n_clients,
            "hollow": n_hollow,
            "frames": self.frames_seen,
            "real_delivered": self.real_delivered,
            "hollow_delivered": self.hollow_delivered_total,
            "delivered": self.real_delivered + self.hollow_delivered_total,
            "evicted_slow": self.evicted_slow,
            "disconnects": self.disconnects,
            "shed": self.shed,
            "sync_streams": self.sync_streams,
            "cpu_s": t[0] + t[1],
            "kinds": per_kind,
        }

    def start_intake(self) -> None:
        threading.Thread(
            target=self._accept_loop, name="relay-accept", daemon=True
        ).start()

    def run(self) -> None:
        """Dispatch forever on the calling thread."""
        self.start_intake()
        try:
            self._dispatch()
        finally:
            self.close()

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for st in self._kinds.values():
            for c in list(st.clients):
                self._drop(st, c, counted=False)
            st.ring.close()  # attach-side close: never unlinks
        try:
            self._sel.close()
        except OSError:
            pass


def _serve_stats(worker: RelayWorker) -> int:
    """Tiny JSON stats endpoint (the netchaos child-process idiom)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = json.dumps(worker.stats()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(
        target=srv.serve_forever, name="relay-stats", daemon=True
    ).start()
    return srv.server_address[1]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="kubernetes_tpu relay worker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--ring", action="append", default=[],
                    metavar="KIND=SHM_NAME", required=True)
    ap.add_argument("--sync-url", required=True)
    ap.add_argument("--tls-cert")
    ap.add_argument("--tls-key")
    ap.add_argument("--hollow", type=int, default=0)
    ap.add_argument("--hollow-kind", default="pods")
    ap.add_argument("--max-pending-bytes", type=int, default=4 << 20)
    ap.add_argument("--bookmark-period", type=float, default=2.0)
    args = ap.parse_args(argv)
    rings = dict(spec.split("=", 1) for spec in args.ring)
    worker = RelayWorker(
        args.host, args.port, rings, args.sync_url,
        tls_cert=args.tls_cert, tls_key=args.tls_key,
        hollow=args.hollow, hollow_kind=args.hollow_kind,
        max_pending_bytes=args.max_pending_bytes,
        bookmark_period_s=args.bookmark_period,
    )
    stats_port = _serve_stats(worker)
    print(f"READY relay-worker {worker.port} {stats_port} {os.getpid()}",
          flush=True)
    import signal

    signal.signal(signal.SIGTERM, lambda *_: worker.stop())
    worker.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
