"""REST client: the APIServer interface over HTTP.

The typed-clientset role of client-go (staging/src/k8s.io/client-go
kubernetes.Interface): every component that takes an `APIServer` (scheduler,
informers, controllers, kubectl) can take a RESTClient instead and run
against a remote API process. Watch uses the newline-delimited JSON stream
(or the length-prefixed binary watch codec when the server speaks it —
apiserver/watchcodec.py) and feeds a local Watcher, exactly how Reflector
consumes watch responses (client-go/tools/cache/reflector.go:210).

Transport: a bounded per-host pool of persistent HTTP/1.1 connections
(client-go's http.Transport keep-alive role). PERFORMANCE.md round-11
measured accept+connect dominating the REST bind cost when every request
opened a fresh TCP connection; `_request`, watch streams, and bind POSTs
all draw from the same pool now. A pooled socket the server closed while
idle is detected at acquire time (pending FIN/EOF) and discarded; the
narrow race where the close lands mid-request reopens ONCE for
idempotent GETs only — a reused connection that dies anywhere in a
bind POST (send or response phase; see the _RETRYABLE_METHODS note for
why a send-phase death is NOT proof of non-delivery) classifies as
QuorumLost through `_classify_bind_transport`: outcome unknown, read
back before any retry, never a blind replay.
"""

from __future__ import annotations

import http.client
import io
import json
import select
import socket
import threading
import time
import urllib.error
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from ..api import serialization as codec
from ..client.apiserver import (
    AlreadyExists,
    Conflict,
    Expired,
    LeaderFenced,
    NotFound,
    NotPrimary,
    TooManyRequests,
)
from ..client.leaderelection import FENCE_HEADER, fence_header_value
from ..runtime.consensus import (
    DegradedWrites,
    DiskFailed,
    DiskPressure,
    QuorumLost,
)
from ..runtime.watch import BOOKMARK, Event, Watcher
from ..utils.metrics import metrics
from ..utils.tracing import TRACE_HEADER, trace_for_binding

# connection-pool observability (SIGUSR2 "serving / REST client" section;
# the serving A/B reads opened vs reused to prove the pool is actually on
# the hot path): opened counts real HTTPConnection creations, reused
# counts requests served on a pooled socket, pool_size is idle sockets
COUNTER_CONN_OPENED = "restclient_connections_opened_total"
COUNTER_CONN_REUSED = "restclient_connections_reused_total"
GAUGE_POOL_SIZE = "restclient_pool_size"
# watch-pump resumes: the pump transparently reconnects a died stream at
# its last delivered rv (labels: reason = error|eof|truncated) — through
# a balancer this is what lets a watcher ride a frontend death with zero
# informer-visible relists (the replacement frontend's cache replays)
COUNTER_WATCH_RECONNECTS = "restclient_watch_reconnects_total"  # {reason}
# HTTP/1.1 pipelining (idempotent GETs only): requests sent back-to-back
# on one pooled connection, responses drained in order; requeues count
# requests pushed back after a mid-pipeline transport error (labels:
# first_in_flight = the one request that classified as retryable,
# unattempted = requests behind it that were never answered)
COUNTER_PIPELINED = "restclient_pipelined_requests_total"
COUNTER_PIPELINE_REQUEUES = "restclient_pipeline_requeues_total"  # {reason}

# replay safety: methods whose transparent one-shot retry after a reused
# connection died cannot double-apply. Deliberately NOT send-phase-gated
# for writes: an EPIPE mid-send proves an RST arrived between our two
# writes, not that the peer ignored the bytes it already had — a proxy
# (or server) killing the connection BECAUSE of this request looks
# identical to an idle close racing it. Idle-closed pooled sockets are
# instead caught at acquire time (pending-EOF check), which is where the
# no-double-send guarantee for binds actually lives.
_RETRYABLE_METHODS = ("GET", "HEAD")

_WATCH_RESUME_ATTEMPTS = 4


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle disabled. http.client writes the header
    block and the body as two separate sends; with Nagle on, the second
    small write stalls behind the peer's delayed ACK (~40 ms) — measured
    as the DOMINANT cost of a pooled bind POST on loopback. TCP_NODELAY
    turns a bind round trip from a delayed-ACK artifact into an actual
    network round trip."""

    def connect(self):
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class _NoDelayHTTPSConnection(http.client.HTTPSConnection):
    """TLS variant: the Nagle/delayed-ACK stall applies identically under
    TLS (the record layer rides the same two-write pattern)."""

    def connect(self):
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


class _NoCloseReader:
    """A file proxy whose close() is a no-op: HTTPResponse closes its fp
    once a response is fully read, but pipelined responses SHARE one
    buffered reader (a per-response makefile could prefetch the next
    response's bytes and lose them) — the window owns the close."""

    __slots__ = ("_fp",)

    def __init__(self, fp):
        self._fp = fp

    def close(self):
        pass

    def flush(self):
        pass

    def __getattr__(self, name):
        return getattr(self._fp, name)


def _tls_client_context(tls_ca: Optional[str]):
    """Client-side TLS context: verify against the given CA bundle, or —
    the fleet-internal default, where the relay/frontend certs are
    self-signed test material — encrypt without verification (the bench
    measures handshake+record crypto cost either way)."""
    import ssl

    if tls_ca:
        return ssl.create_default_context(cafile=tls_ca)
    ctx = ssl._create_unverified_context()
    return ctx


def _new_connection(
    scheme: str, host: str, port: int, timeout: float,
    tls_ctx=None, tls_ca: Optional[str] = None,
) -> http.client.HTTPConnection:
    if scheme == "https":
        return _NoDelayHTTPSConnection(
            host, port, timeout=timeout,
            context=tls_ctx or _tls_client_context(tls_ca),
        )
    return _NoDelayHTTPConnection(host, port, timeout=timeout)


class HTTPConnectionPool:
    """Bounded per-host idle pool of persistent http.client connections.

    acquire() pops an idle connection for the host (discarding stale ones
    the server closed while they sat idle — a readable socket with a
    pending EOF), else hands out a fresh one; release() returns a healthy
    keep-alive connection; discard() closes one that died or was consumed
    by a stream. Thread-safe; the pool never blocks a caller waiting for
    a slot — the bound is on IDLE sockets kept, not on concurrency."""

    def __init__(
        self,
        max_idle_per_host: int = 8,
        timeout: float = 30.0,
        tls_ca: Optional[str] = None,
    ):
        self.max_idle_per_host = max_idle_per_host
        self.timeout = timeout
        self._lock = threading.Lock()
        # keyed by (scheme, host, port): an https socket is never handed
        # to a plaintext request and vice versa
        self._idle: Dict[
            Tuple[str, str, int], List[http.client.HTTPConnection]
        ] = {}
        self._idle_count = 0
        self._tls_ca = tls_ca
        self._tls_ctx = None  # built lazily on the first https acquire

    @staticmethod
    def _stale(conn: http.client.HTTPConnection) -> bool:
        """An idle keep-alive socket must have NOTHING to say. Readable
        means the server closed it (pending FIN) or broke protocol
        (unsolicited bytes) — either way it cannot carry a request."""
        sock = conn.sock
        if sock is None:
            return True
        try:
            readable, _, errored = select.select([sock], [], [sock], 0)
        except (OSError, ValueError):
            return True
        return bool(readable or errored)

    def acquire(
        self, host: str, port: int, scheme: str = "http"
    ) -> Tuple[http.client.HTTPConnection, bool]:
        """(connection, reused): reused=True means it already carried at
        least one request on this socket (retry policy branches on it)."""
        key = (scheme, host, port)
        while True:
            with self._lock:
                idle = self._idle.get(key)
                conn = idle.pop() if idle else None
                if conn is not None:
                    self._idle_count -= 1
                    metrics.set_gauge(GAUGE_POOL_SIZE, self._idle_count)
            if conn is None:
                break
            if self._stale(conn):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            metrics.inc(COUNTER_CONN_REUSED)
            return conn, True
        if scheme == "https" and self._tls_ctx is None:
            self._tls_ctx = _tls_client_context(self._tls_ca)
        conn = _new_connection(
            scheme, host, port, self.timeout, tls_ctx=self._tls_ctx
        )
        metrics.inc(COUNTER_CONN_OPENED)
        return conn, False

    def release(self, host: str, port: int, conn, scheme: str = "http") -> None:
        with self._lock:
            idle = self._idle.setdefault((scheme, host, port), [])
            if len(idle) >= self.max_idle_per_host:
                pass  # over the idle bound: close below instead
            else:
                idle.append(conn)
                self._idle_count += 1
                metrics.set_gauge(GAUGE_POOL_SIZE, self._idle_count)
                return
        try:
            conn.close()
        except OSError:
            pass

    def discard(self, conn) -> None:
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
            self._idle_count = 0
            metrics.set_gauge(GAUGE_POOL_SIZE, 0)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def size(self) -> int:
        with self._lock:
            return self._idle_count


class RESTClient:
    """degraded_retries / degraded_retry_cap_s: a fast-fail 503 from a
    degraded read-only store (reason "Degraded": the write gate refused
    BEFORE applying anything, runtime/consensus.py) is transparently
    retried — the client honors the Retry-After header (capped) for up
    to degraded_retries attempts before surfacing DegradedWrites. A
    "WriteQuorumLost" 503 (the write applied locally but missed quorum:
    outcome unknown) surfaces as QuorumLost without replay, and a 503
    with no Retry-After (fenced ex-primary) surfaces as NotPrimary.

    pool_connections: idle keep-alive sockets kept per host (0 disables
    the pool entirely — every request opens and closes its own
    connection, the pre-pool behavior the serving A/B baselines)."""

    def __init__(
        self,
        base_url: str,
        timeout: float = 30.0,
        degraded_retries: int = 3,
        degraded_retry_cap_s: float = 2.0,
        pool_connections: int = 8,
        tls_ca: Optional[str] = None,
    ):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        self.degraded_retries = degraded_retries
        self.degraded_retry_cap_s = degraded_retry_cap_s
        self.tls_ca = tls_ca
        self._headers: dict = {}
        self.pool: Optional[HTTPConnectionPool] = (
            HTTPConnectionPool(pool_connections, timeout=timeout, tls_ca=tls_ca)
            if pool_connections
            else None
        )

    # -- transport -----------------------------------------------------------

    def _url(self, resource: str, namespace: str, name: str = "") -> str:
        # empty namespace = cluster-scoped path (the store keys by the
        # object's own namespace either way)
        if namespace:
            path = f"/api/v1/namespaces/{namespace}/{resource}"
        else:
            path = f"/api/v1/{resource}"
        if name:
            path += f"/{name}"
        return self.base + path

    def _acquire(self, host: str, port: int, scheme: str = "http"):
        if self.pool is not None:
            return self.pool.acquire(host, port, scheme)
        conn = _new_connection(
            scheme, host, port, self.timeout, tls_ca=self.tls_ca
        )
        metrics.inc(COUNTER_CONN_OPENED)
        return conn, False

    def _park(self, host: str, port: int, conn, resp,
              scheme: str = "http") -> None:
        """Return a connection after a fully-read response: back to the
        pool when the response allows reuse, closed otherwise."""
        if self.pool is None or resp.will_close:
            try:
                conn.close()
            except OSError:
                pass
            return
        self.pool.release(host, port, conn, scheme)

    def _discard(self, conn) -> None:
        if self.pool is not None:
            self.pool.discard(conn)
        else:
            try:
                conn.close()
            except OSError:
                pass

    def _http(
        self,
        method: str,
        url: str,
        data: Optional[bytes] = None,
        headers: Optional[dict] = None,
        stream: bool = False,
    ):
        """One HTTP exchange over a pooled connection.

        Non-stream: (status, reason, headers, body) with the connection
        returned to the pool. stream=True: (response, conn, host, port)
        with the UNREAD response and connection owned by the caller (a
        watch stream holds its socket for its lifetime and discards it).

        Stale-reuse retry contract: a REUSED connection that dies under
        a GET/HEAD reopens once transparently; under a write it raises —
        the request may have been applied with the ack lost (for a bind
        POST that is exactly the QuorumLost shape: the caller's
        read-back reconciler resolves it, never a blind replay).
        Fresh-connection failures never retry here."""
        u = urlsplit(url)
        scheme = u.scheme or "http"
        host = u.hostname or "127.0.0.1"
        port = u.port or (443 if scheme == "https" else 80)
        path = u.path + (f"?{u.query}" if u.query else "")
        hdrs = dict(headers or {})
        if self.pool is None:
            hdrs.setdefault("Connection", "close")
        retried = False
        while True:
            conn, reused = self._acquire(host, port, scheme)
            try:
                conn.request(method, path, body=data, headers=hdrs)
                resp = conn.getresponse()
            except (ConnectionResetError, BrokenPipeError,
                    http.client.BadStatusLine) as e:
                # RemoteDisconnected subclasses both BadStatusLine and
                # ConnectionResetError: the server closed without a
                # response — the stale-pooled-socket signature
                self._discard(conn)
                if reused and not retried and method in _RETRYABLE_METHODS:
                    retried = True
                    continue
                if isinstance(e, http.client.BadStatusLine) and not isinstance(
                    e, http.client.RemoteDisconnected
                ):
                    raise OSError(f"malformed response: {e}") from e
                raise
            except (OSError, http.client.HTTPException) as e:
                self._discard(conn)
                if isinstance(e, OSError):
                    raise
                raise OSError(str(e)) from e
            if stream:
                return resp, conn, host, port
            try:
                body = resp.read()
            except OSError:
                self._discard(conn)
                raise
            self._park(host, port, conn, resp, scheme)
            return resp.status, resp.reason, resp.headers, body

    def _request_raw(
        self,
        method: str,
        url: str,
        body: Optional[dict] = None,
        headers: Optional[dict] = None,
    ) -> bytes:
        """Shared request plumbing: pooled transport, degraded-503 retry,
        and the full HTTP error taxonomy. get_text/post_text ride this
        too — a degraded store no longer fast-fails log/exec
        subresources with an unmapped error."""
        data = json.dumps(body).encode() if body is not None else None
        attempt = 0
        while True:
            status, reason, hdrs, raw = self._http(
                method,
                url,
                data,
                {
                    "Content-Type": "application/json",
                    **self._headers,
                    **(headers or {}),
                },
            )
            if 200 <= status < 300:
                return raw
            payload = {}
            try:
                payload = json.loads(raw.decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                pass
            msg = payload.get("message", f"HTTP Error {status}: {reason}")
            if status == 404:
                raise NotFound(msg)
            if status == 409:
                err_reason = payload.get("reason", "")
                if err_reason == "AlreadyExists":
                    raise AlreadyExists(msg)
                if err_reason == "LeaderFenced":
                    # leadership fence rejection: the caller's lease
                    # grant was superseded — non-retryable (the caller
                    # is not the leader anymore), nothing was applied
                    raise LeaderFenced(msg)
                raise Conflict(msg)
            if status == 503:
                # three distinct 503 contracts (rest.py):
                #   "Degraded"        gate refused before applying:
                #                     replaying is safe — honor
                #                     Retry-After (capped) and retry;
                #                     the store re-opens the moment
                #                     followers catch the commit up
                #   "WriteQuorumLost" THIS request applied locally but
                #                     missed quorum: outcome unknown —
                #                     a blind replay would 409 against
                #                     its own first attempt; surface it
                #   "DiskFailed"      the replica's WAL sink is
                #                     fail-stopped: the gate refused
                #                     before applying, so replaying is
                #                     safe — bounded retries ride out a
                #                     leader failover to a disk-healthy
                #                     replica
                #   "DiskPressure"    WAL volume low on space: refused
                #                     before applying; retry while
                #                     compaction/reclaim frees space
                #   no Retry-After    fenced primary (permanent for
                #                     that process): never hammer it —
                #                     callers must re-discover the
                #                     leader
                err_reason = payload.get("reason", "")
                retry_after = hdrs.get("Retry-After")
                if retry_after is None:
                    raise NotPrimary(msg)
                if err_reason == "WriteQuorumLost":
                    raise QuorumLost(msg)
                if attempt < self.degraded_retries:
                    attempt += 1
                    try:
                        delay = float(retry_after)
                    except ValueError:
                        delay = 0.5
                    time.sleep(min(delay, self.degraded_retry_cap_s))
                    continue
                if err_reason == "DiskFailed":
                    raise DiskFailed(msg)
                if err_reason == "DiskPressure":
                    raise DiskPressure(msg)
                raise DegradedWrites(msg)
            raise urllib.error.HTTPError(url, status, msg, hdrs, io.BytesIO(raw))

    def _request(
        self,
        method: str,
        url: str,
        body: Optional[dict] = None,
        headers: Optional[dict] = None,
    ) -> dict:
        return json.loads(self._request_raw(method, url, body, headers) or b"{}")

    # -- HTTP/1.1 pipelining (idempotent GETs only) --------------------------

    def _http_error_for(self, url, status, reason, hdrs, raw) -> Exception:
        """The _request_raw error taxonomy as a one-shot classifier (no
        degraded-503 sleep/retry loop: the pipeline path surfaces the
        typed error and lets the caller decide)."""
        payload = {}
        try:
            payload = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            pass
        msg = payload.get("message", f"HTTP Error {status}: {reason}")
        err_reason = payload.get("reason", "")
        if status == 404:
            return NotFound(msg)
        if status == 409:
            if err_reason == "AlreadyExists":
                return AlreadyExists(msg)
            if err_reason == "LeaderFenced":
                return LeaderFenced(msg)
            return Conflict(msg)
        if status == 410:
            return Expired(msg)
        if status == 503:
            if hdrs.get("Retry-After") is None:
                return NotPrimary(msg)
            if err_reason == "WriteQuorumLost":
                return QuorumLost(msg)
            if err_reason == "DiskFailed":
                return DiskFailed(msg)
            if err_reason == "DiskPressure":
                return DiskPressure(msg)
            return DegradedWrites(msg)
        return urllib.error.HTTPError(url, status, msg, hdrs, io.BytesIO(raw))

    def pipelined_get_raw(
        self,
        urls: List[str],
        headers: Optional[dict] = None,
        depth: int = 8,
    ) -> List[bytes]:
        """K idempotent GETs pipelined on one pooled connection.

        Requests go out back-to-back in windows of ``depth`` and the
        responses drain IN ORDER off the same socket — one connection,
        one round trip of latency for the whole window instead of K.

        Mid-pipeline transport error contract: only the FIRST in-flight
        request (sent, unanswered, no response bytes consumed for it)
        may classify as retryable — it gets the same one-shot
        reused-connection retry a plain GET gets; every request behind
        it was never attempted by the server as far as we can prove, so
        those requeue unattempted WITHOUT consuming retry budget. Bind
        POSTs never ride this path (`_classify_bind_transport` keeps
        writes strictly one-at-a-time).

        Responses within one window share a single buffered reader:
        a per-response ``makefile`` could prefetch bytes belonging to
        the NEXT response and lose them with the file object.
        """
        results: List[Optional[bytes]] = [None] * len(urls)
        pending = deque(enumerate(urls))
        retried: set = set()
        base_hdrs = {**self._headers, **(headers or {})}
        while pending:
            window = []
            while pending and len(window) < depth:
                window.append(pending.popleft())
            u = urlsplit(window[0][1])
            scheme = u.scheme or "http"
            host = u.hostname or "127.0.0.1"
            port = u.port or (443 if scheme == "https" else 80)
            conn, reused = self._acquire(host, port, scheme)
            completed = 0
            fp = None
            try:
                if conn.sock is None:
                    conn.connect()
                sock = conn.sock
                out = []
                for _idx, url in window:
                    pu = urlsplit(url)
                    path = pu.path + (f"?{pu.query}" if pu.query else "")
                    lines = [
                        f"GET {path} HTTP/1.1",
                        f"Host: {host}:{port}",
                        "Accept-Encoding: identity",
                    ]
                    lines += [f"{k}: {v}" for k, v in base_hdrs.items()]
                    out.append(
                        ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                    )
                sock.sendall(b"".join(out))
                metrics.inc(COUNTER_PIPELINED, by=len(window))
                fp = sock.makefile("rb")
                shared = _NoCloseReader(fp)
                last_resp = None
                early_close = False
                for j, (idx, url) in enumerate(window):
                    resp = http.client.HTTPResponse(sock, method="GET")
                    resp.fp.close()
                    resp.fp = shared  # shared reader: see docstring
                    resp.begin()
                    body = resp.read()
                    if not (200 <= resp.status < 300):
                        raise self._http_error_for(
                            url, resp.status, resp.reason, resp.headers, body
                        )
                    results[idx] = body
                    completed = j + 1
                    last_resp = resp
                    if resp.will_close and j + 1 < len(window):
                        # the server is closing after this response: the
                        # unanswered tail requeues unattempted
                        tail = window[j + 1:]
                        for item in reversed(tail):
                            pending.appendleft(item)
                        metrics.inc(
                            COUNTER_PIPELINE_REQUEUES,
                            {"reason": "unattempted"}, by=len(tail),
                        )
                        early_close = True
                        break
                if early_close or last_resp is None or last_resp.will_close:
                    self._discard(conn)
                else:
                    self._park(host, port, conn, last_resp, scheme)
            except (OSError, http.client.HTTPException) as e:
                self._discard(conn)
                in_flight = window[completed:]
                if not in_flight:
                    raise
                first, rest = in_flight[0], in_flight[1:]
                for item in reversed(rest):
                    pending.appendleft(item)
                if rest:
                    metrics.inc(
                        COUNTER_PIPELINE_REQUEUES,
                        {"reason": "unattempted"}, by=len(rest),
                    )
                # only the first in-flight request classifies as
                # retryable — and only with the plain GET's one-shot
                # reused-connection policy
                if reused and first[0] not in retried:
                    retried.add(first[0])
                    pending.appendleft(first)
                    metrics.inc(
                        COUNTER_PIPELINE_REQUEUES,
                        {"reason": "first_in_flight"},
                    )
                    continue
                if isinstance(e, http.client.HTTPException) and not isinstance(
                    e, OSError
                ):
                    raise OSError(str(e)) from e
                raise
            finally:
                if fp is not None:
                    try:
                        fp.close()
                    except OSError:
                        pass
        return results  # type: ignore[return-value]

    def get_many(
        self, kind: str, namespace: str, names: List[str], depth: int = 8
    ) -> List[Any]:
        """Pipelined typed point-gets: K objects in ~one round trip."""
        urls = [self._url(kind, namespace, n) for n in names]
        return [
            codec.decode(kind, json.loads(raw or b"{}"))
            for raw in self.pipelined_get_raw(urls, depth=depth)
        ]

    def get_text(self, resource: str, namespace: str, name: str) -> str:
        """Plain-text GET of a subresource (pods/{name}/log): shared
        plumbing with the JSON path — same pool, same degraded-503
        retry, same typed error taxonomy (get_raw is the JSON variant
        for aggregated API paths)."""
        return self._request_raw(
            "GET", self._url(resource, namespace, name)
        ).decode()

    def post_text(self, resource: str, namespace: str, name: str, body: dict) -> str:
        """Plain-text POST to a subresource (pods/{name}/exec): same
        shared plumbing as get_text."""
        return self._request_raw(
            "POST", self._url(resource, namespace, name), body
        ).decode()

    def get_raw(self, path: str) -> dict:
        """GET an arbitrary API path (aggregated APIs like metrics.k8s.io)."""
        return self._request("GET", self.base + path)

    def backup_state(self) -> dict:
        """Online consistent backup image from the live server
        (/debug/backup — the `ktpu-backup save --url` path)."""
        return self.get_raw("/debug/backup")

    def close(self) -> None:
        """Drop the idle connection pool (tests / process teardown)."""
        if self.pool is not None:
            self.pool.close()

    # -- the APIServer interface ---------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        out = self._request(
            "POST",
            self._url(kind, obj.metadata.namespace),
            codec.encode(obj),
        )
        return codec.decode(kind, out)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        out = self._request("GET", self._url(kind, namespace, name))
        return codec.decode(kind, out)

    def update(self, kind: str, obj: Any, check_version: bool = True) -> Any:
        out = self._request(
            "PUT",
            self._url(kind, obj.metadata.namespace, obj.metadata.name),
            codec.encode(obj),
        )
        return codec.decode(kind, out)

    def guaranteed_update(
        self, kind: str, namespace: str, name: str, mutate: Callable[[Any], Any]
    ) -> Any:
        while True:
            cur = self.get(kind, namespace, name)
            new = mutate(cur)
            if new is None:
                return cur
            try:
                return self.update(kind, new)
            except Conflict:
                continue

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        return self._request("DELETE", self._url(kind, namespace, name))

    def list(self, kind: str, namespace: Optional[str] = None) -> Tuple[List[Any], int]:
        url = self._url(kind, namespace or "")
        out = self._request("GET", url)
        rv = int(out.get("metadata", {}).get("resourceVersion", 0))
        items = [codec.decode(kind, item) for item in out.get("items", [])]
        if namespace is not None:
            items = [o for o in items if o.metadata.namespace == namespace]
        return items, rv

    def kind_resource_version(self, kind: str) -> int:
        """rv of the newest event OF THIS KIND at the server (the
        freshness target for consistent cache-served lists — see
        APIServer.kind_resource_version). Served by a dedicated cheap
        query (?kindResourceVersion=1, no object payload); a frontend
        chain forwards it upstream to the primary."""
        out = self._request(
            "GET", self._url(kind, "") + "?kindResourceVersion=1"
        )
        return int(out.get("kindResourceVersion", 0) or 0)

    def pod_logs(
        self, namespace: str, name: str, tail_lines: Optional[int] = None
    ) -> str:
        """pods/{name}/log over REST (the store surface rest.py serves a
        frontend from)."""
        url = self._url("pods", namespace, f"{name}/log")
        if tail_lines is not None:
            url += f"?tailLines={tail_lines}"
        return self._request_raw("GET", url).decode()

    def pod_exec(self, namespace: str, name: str, command) -> str:
        """pods/{name}/exec over REST (frontend store surface)."""
        return self.post_text(
            "pods", namespace, f"{name}/exec", {"command": list(command)}
        )

    def evict_pod(
        self, namespace: str, name: str, retries_429: int = 2
    ) -> None:
        """pods/{name}/eviction over REST; a PDB/ratelimit refusal (429)
        maps back to TooManyRequests like the in-process store.

        429s carrying a Retry-After header are honored (previously the
        first refusal gave up outright): up to ``retries_429`` paced
        retries sleep out the server's hint — a disruption-controller
        budget resync away from succeeding — each capped at
        degraded_retry_cap_s like the 503 path. A refusal that survives
        the retries (or carries no hint) raises TooManyRequests with the
        hint attached as ``retry_after_s``, so a paced drainer (the
        descheduler's wave loop) can schedule its next attempt instead
        of hammering."""
        attempt = 0
        while True:
            try:
                self._request(
                    "POST",
                    self._url("pods", namespace, f"{name}/eviction"),
                    {"podName": name, "podNamespace": namespace},
                )
                return
            except urllib.error.HTTPError as e:
                if e.code != 429:
                    raise
                raw_hint = (e.headers or {}).get("Retry-After")
                delay = None
                if raw_hint is not None:
                    try:
                        delay = float(raw_hint)
                    except ValueError:
                        delay = 1.0
                if delay is not None and attempt < retries_429:
                    attempt += 1
                    time.sleep(min(delay, self.degraded_retry_cap_s))
                    continue
                err = TooManyRequests(str(e))
                err.retry_after_s = delay
                raise err from None

    # -- watch ---------------------------------------------------------------

    def _open_watch(self, kind: str, from_version: int):
        """One watch stream connect. Returns (resp, conn) with the codec
        decided by the RESPONSE Content-Type: the request offers the
        binary watch codec via Accept, an old server ignores it and
        answers JSON lines — negotiation degrades to the universal wire.
        Raises Expired on 410 (resume position outside the window) and
        OSError on transport/HTTP-level failure."""
        from .watchcodec import WATCH_CONTENT_TYPE

        url = self._url(kind, "") + f"?watch=1&resourceVersion={from_version}"
        resp, conn, _host, _port = self._http(
            "GET",
            url,
            None,
            {**self._headers, "Accept": WATCH_CONTENT_TYPE},
            stream=True,
        )
        if resp.status != 200:
            try:
                body = resp.read().decode()
            except OSError:
                body = ""
            self._discard(conn)
            if resp.status == 410:
                raise Expired(body or "resourceVersion too old")
            raise OSError(f"watch connect failed: HTTP {resp.status} {body}")
        # the STREAM clears the socket timeout: an idle but healthy watch
        # must not be killed by a read timeout (the connect itself was
        # bounded by the client timeout)
        sock = conn.sock
        if sock is not None:
            sock.settimeout(None)
        return resp, conn

    def _pump_stream(self, kind: str, resp, w: Watcher, last_rv: int) -> Tuple[int, str]:
        """Drain one watch stream into the Watcher until it ends.
        Returns (last delivered rv, end reason for the reconnect
        counter). Decodes binary frames when the server negotiated the
        compact codec, newline-JSON otherwise."""
        from . import watchcodec
        from .cacher import bookmark_object

        ctype = resp.headers.get("Content-Type") or ""
        try:
            if watchcodec.WATCH_CONTENT_TYPE in ctype:
                while not w.stopped:
                    frame = watchcodec.read_frame(resp)
                    if frame is None:
                        return last_rv, "eof"
                    ev_type, rv, obj = frame
                    if ev_type == BOOKMARK:
                        w.push(Event(BOOKMARK, bookmark_object(kind, rv), rv))
                    else:
                        if isinstance(obj, dict):
                            obj = codec.decode(kind, obj)  # 'J' fallback frame
                        w.push(Event(ev_type, obj, rv))
                    last_rv = max(last_rv, rv)
                return last_rv, "stopped"
            for line in resp:
                if w.stopped:
                    return last_rv, "stopped"
                line = line.strip()
                if not line:
                    continue
                msg = json.loads(line)
                if msg["type"] == BOOKMARK:
                    # rv-only progress notify from the watch cache
                    # (idle heartbeat / window keep-alive): carry
                    # the rv through; informers advance their
                    # resume position on it, other consumers skip
                    # unknown event types
                    rv = int(
                        (msg.get("object") or {})
                        .get("metadata", {})
                        .get("resourceVersion", 0)
                    )
                    w.push(Event(BOOKMARK, bookmark_object(kind, rv), rv))
                    last_rv = max(last_rv, rv)
                    continue
                obj = codec.decode(kind, msg["object"])
                rv = obj.metadata.resource_version
                w.push(Event(msg["type"], obj, rv))
                last_rv = max(last_rv, rv)
            return last_rv, "eof"
        except ValueError:
            return last_rv, "truncated"
        except Exception:
            return last_rv, "error"

    def watch(self, kind: str, from_version: int = 0) -> Watcher:
        w = Watcher()
        # open SYNCHRONOUSLY so a 410 Gone ("resourceVersion too old")
        # surfaces to the caller as Expired — informers re-list on it; a
        # silent pump-thread death would hand them a gapped stream. Other
        # connection errors keep the old contract (a stopped watcher, not
        # an exception).
        try:
            resp, conn = self._open_watch(kind, from_version)
        except Expired:
            raise
        except OSError:
            w.stop()
            return w

        def pump(resp, conn):
            last_rv = from_version
            stalled = 0  # consecutive resumes that delivered nothing new
            while True:
                rv_before = last_rv
                try:
                    last_rv, reason = self._pump_stream(kind, resp, w, last_rv)
                finally:
                    self._discard(conn)  # a stream's socket is never reused
                if w.stopped or reason == "stopped":
                    break
                # a resume is only "transparent" while it makes progress:
                # a poison event pinned at a fixed rv (decode raises, rv
                # never advances) would otherwise reconnect successfully
                # at full speed forever — _open_watch succeeding means the
                # connect backoff below never engages. Bound consecutive
                # zero-progress resumes and back off between them; hitting
                # the bound stops the watcher, handing the consumer its
                # relist path (same contract as falling out of the window).
                if last_rv > rv_before:
                    stalled = 0
                else:
                    stalled += 1
                    if stalled >= _WATCH_RESUME_ATTEMPTS:
                        w.stop()
                        return
                    time.sleep(min(0.05 * (2 ** (stalled - 1)), 1.0))
                    if w.stopped:
                        return
                # transparent resume at the last delivered rv: through a
                # balancer this lands on ANY healthy frontend, whose
                # watch cache replays the gap from its event window —
                # the consumer sees one continuous stream, no relist
                metrics.inc(COUNTER_WATCH_RECONNECTS, {"reason": reason})
                backoff = 0.05
                for _attempt in range(_WATCH_RESUME_ATTEMPTS):
                    try:
                        resp, conn = self._open_watch(kind, last_rv)
                        break
                    except Expired:
                        # fell out of the window mid-death: stopping the
                        # watcher hands the consumer its relist path
                        w.stop()
                        return
                    except OSError:
                        if w.stopped:
                            return
                        time.sleep(backoff)
                        backoff = min(backoff * 2, 1.0)
                else:
                    w.stop()
                    return

            w.stop()

        threading.Thread(
            target=pump, args=(resp, conn), daemon=True, name=f"watch-{kind}"
        ).start()
        return w

    # -- binds ---------------------------------------------------------------

    @staticmethod
    def _fence_headers(fence) -> Optional[dict]:
        return (
            {FENCE_HEADER: fence_header_value(fence)}
            if fence is not None
            else None
        )

    @staticmethod
    def _bind_headers(base: Optional[dict], binding) -> Optional[dict]:
        """Fence headers plus trace-context propagation: the pod's trace
        id (minted at queue admission in THIS process) rides the
        X-Trace-Context header so the store process stamps its apply —
        or its LeaderFenced rejection — under the same identity."""
        tid = trace_for_binding(binding)
        if not tid:
            return base
        return {**(base or {}), TRACE_HEADER: tid}

    @staticmethod
    def _classify_bind_transport(e: Exception) -> DegradedWrites:
        """Map a transport-level failure of a /binding POST onto the bind
        outcome taxonomy. A refused connect means the request never
        reached the server — retryable, same contract as a degraded-store
        refusal (nothing applied, safe to replay verbatim). ANYTHING else
        (timeout, reset, EOF-without-response, half-delivered body) means
        the request MAY have been processed with its response lost: the
        one honest classification is QuorumLost — the caller must read
        the pod back before any retry, never blindly replay (a netchaos
        blackhole is exactly this shape: write applied, ack dropped).
        The pool's stale-reuse reopen never reaches here for binds at
        all: _http's transparent one-shot retry covers idempotent GETs
        only (_RETRYABLE_METHODS) — every reused-connection death on a
        bind POST, send-phase included, lands in this classifier."""
        cause = getattr(e, "reason", e)  # URLError wraps the socket error
        if isinstance(cause, ConnectionRefusedError):
            return DegradedWrites(f"api server unreachable: {cause}")
        return QuorumLost(f"bind outcome unknown (transport failure: {e})")

    def bind_pod(self, binding, fence=None) -> None:
        """Single-pod binding subresource (DefaultBinder's surface; the
        bulk bind_pods below shares the wire path). Raises on failure so
        the bind plugin's error handling fires like the in-process store.
        fence: optional BindFence, attached as the X-Leadership-Fence
        header; the server rejects with LeaderFenced when superseded."""
        try:
            self._request(
                "POST",
                self.base
                + f"/api/v1/namespaces/{binding.pod_namespace}/pods/"
                + f"{binding.pod_name}/binding",
                codec.encode(binding),
                headers=self._bind_headers(self._fence_headers(fence), binding),
            )
        except (
            LeaderFenced,
            DegradedWrites,
            NotFound,
            Conflict,
            urllib.error.HTTPError,
        ):
            raise
        except OSError as e:
            raise self._classify_bind_transport(e) from e

    def bind_pods(self, bindings, fence=None) -> list:
        """Per-binding error list (None = bound). Retryable degraded-store
        refusals come back as the EXCEPTION OBJECT (DegradedWrites /
        QuorumLost), not a string — the scheduler's ride-through layer
        parks those placements instead of failing them. After the first
        degraded refusal the remaining bindings are not attempted (each
        would burn its own client-side retry budget against a store that
        just said "read-only"); they get a fresh DegradedWrites — none of
        them was applied, so replaying them later is safe. Transport
        failures classify through _classify_bind_transport: refused
        connect = retryable DegradedWrites, anything after the connect =
        QuorumLost (outcome unknown, read back before retrying).

        fence: the leadership fencing token (BindFence), attached to every
        binding POST as the X-Leadership-Fence header and validated by the
        server against the live lease under the bind lock. A LeaderFenced
        rejection RAISES (mirroring the in-process store's whole-batch
        reject): the remaining bindings are not attempted — the caller is
        not the leader anymore. Bindings that already landed in this batch
        were applied while the grant was still valid and stay applied
        exactly once; the new leader's adoption pass reads them back."""
        errors = []
        degraded: Optional[DegradedWrites] = None
        fence_headers = self._fence_headers(fence)  # one token per batch
        for b in bindings:
            if degraded is not None:
                errors.append(
                    DegradedWrites(f"not attempted: {degraded}")
                )
                continue
            try:
                self._request(
                    "POST",
                    self.base
                    + f"/api/v1/namespaces/{b.pod_namespace}/pods/"
                    + f"{b.pod_name}/binding",
                    codec.encode(b),
                    headers=self._bind_headers(fence_headers, b),
                )
                errors.append(None)
            except LeaderFenced:
                # deposed mid-batch: nothing further may apply. Raise like
                # the in-process store's atomic whole-batch reject; the
                # scheduler's _on_fenced_binds drops every placement (the
                # already-landed prefix is re-adopted from informer state)
                raise
            except QuorumLost as e:
                # THIS binding applied remotely but missed quorum: its
                # outcome is unknown — surface the exception itself so the
                # caller reads the pod back before any retry
                errors.append(e)
                degraded = e
            except DegradedWrites as e:
                errors.append(e)
                degraded = e
            except (NotFound, Conflict) as e:
                # typed like the in-process store's error list, so the
                # scheduler's reconciler branches identically over REST
                errors.append(e)
            except urllib.error.HTTPError as e:
                # a non-2xx the taxonomy doesn't know (500, 403, ...):
                # the server DID answer — a known refusal, not unknown
                errors.append(str(e))
            except OSError as e:
                # transport failure (partition, reset, blackholed ack):
                # classify, then stop attempting the rest of the batch —
                # the network just proved undeliverable and each further
                # attempt would burn its own timeout
                err = self._classify_bind_transport(e)
                errors.append(err)
                degraded = err
            except Exception as e:
                errors.append(str(e))
        return errors


def serving_health_lines() -> List[str]:
    """REST-client transport state for the SIGUSR2 dump: pool occupancy,
    opened-vs-reused connection counts, and watch-pump resume counters —
    whether the serving tier's keep-alive path is actually hot is
    diagnosable from one signal."""
    lines: List[str] = []
    for snap in (
        metrics.snapshot_gauges("restclient_"),
        metrics.snapshot_counters("restclient_"),
    ):
        for name, labels, value in snap:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines


class AuthRESTClient(RESTClient):
    """RESTClient sending a bearer token (kubeconfig user credentials)."""

    def __init__(self, base_url: str, token: str, timeout: float = 30.0):
        super().__init__(base_url, timeout=timeout)
        self._headers["Authorization"] = f"Bearer {token}"
