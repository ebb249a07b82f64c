"""The port's serving tier off the device: the harness's host-only
benches (kubernetes_tpu_torch/perf/harness.py: run_readpath_benchmark,
run_serving_benchmark, run_relay_serving_benchmark,
run_durability_benchmark, the reference's definitions) at small sizes,
held to the invariants the reference's runs hold them to; the
reference's pooled REST client, watch codec and follower-read tests
(tests/test_serving.py); and the multi-process scenarios, whose
children run the port's testing/netchaos_procs.py (its scheduler role
with --platform cpu): the frontend fleet under a storm
(tests/test_chaos_serving.py) and the partitioned, SIGSTOPped and traced
scheduler replicas (the multi-process cases of tests/test_chaos_net.py).
The reference marks the multi-process scenarios slow, and so does this
file. Each section below is the reference file named in its heading with
its imports pointed at the port; helpers that two reference files define
differently carry the file's tag, and the helpers the reference imports
from its other test files (tests/test_chaos_pipeline.py) are defined
here over the port's objects. The relay bench serves TLS, which needs
the openssl binary (testing/tlsutil.py). Tolerances: exact.
"""

from kubernetes_tpu_torch.perf.harness import (
    run_durability_benchmark,
    run_readpath_benchmark,
    run_relay_serving_benchmark,
    run_serving_benchmark,
)
from kubernetes_tpu_torch.utils.metrics import metrics


def test_readpath_bench_fans_out_from_one_store_watch():
    r = run_readpath_benchmark(n_informers=300, n_events=20, n_sampled=16)
    assert r.store_watchers == 1
    assert r.fanout_deliveries == r.n_events * r.n_informers == 6000
    assert r.delivery_p99_ms >= r.delivery_p50_ms > 0
    assert r.slow_evicted == 0


def test_durability_bench_recovers_every_record():
    # the reference's bench reads the fsync histogram's `.count`, which
    # Histogram does not have (its count is `.n`): it raises once an
    # earlier fsynced append in the process made the histogram. Start
    # from empty metrics, as a fresh process does.
    metrics.reset()
    r = run_durability_benchmark(n_records=2000, batch=64, fsync_records=128)
    assert r.recovered_rv == r.n_records == 2000
    assert r.append_fsync_per_s > 0 and r.append_nofsync_per_s > 0
    assert r.fsync_p99_ms >= r.fsync_p50_ms >= 0


def test_serving_bench_binds_every_pod_through_the_fleet():
    r = run_serving_benchmark(n_watchers=200, n_frontends=2, n_pods=10, timeout_s=120)
    assert r.n_binds == 10
    assert r.n_events == 20
    assert r.n_watchers >= 200
    assert r.fanout_deliveries == r.n_events * r.n_watchers
    assert r.conn_reused > 0


def test_relay_serving_bench_binds_every_pod_over_tls():
    r = run_relay_serving_benchmark(
        n_watchers=400, n_frontends=1, relay_workers=1, n_real_clients=2,
        n_pods=10, tls=True, timeout_s=120,
    )
    assert r.tls and r.n_binds == 10
    assert r.n_watchers >= 400 and r.n_real_clients == 2
    assert r.fanout_deliveries == r.n_events * r.n_watchers
    assert r.deliveries_measured > 0
    assert len(r.frontend_cpu_s) == 1 and len(r.worker_cpu_s) == 1


# -- tests/test_serving.py ---------------------------------------------
# Serving-tier transport + topology units: the pooled REST client's
# connection-reuse failure edges, watch-codec negotiation, the balancer,
# and RV-consistent follower reads.
#
# The contracts under test:
#   * a stale pooled socket (server closed it idle) reopens exactly once
#     and never double-sends a bind;
#   * a reused connection that dies mid-bind-POST (request delivered, ack
#     lost) classifies as QuorumLost — never a transparent replay;
#   * binary watch-codec negotiation falls back to newline-JSON against a
#     server that doesn't speak it;
#   * a follower read demanding an rv ahead of the follower's commit index
#     blocks until the commit catches up (or 504s with Retry-After on
#     timeout — the cacher's freshness-wait contract, generalized to the
#     commit index).
import copy
import json
import socket
import threading
import time
import urllib.request

import pytest

from kubernetes_tpu_torch.api import serialization as codec
from kubernetes_tpu_torch.api.objects import (
    Binding,
    Container,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.apiserver.client import (
    COUNTER_CONN_OPENED,
    COUNTER_CONN_REUSED,
    COUNTER_WATCH_RECONNECTS,
    HTTPConnectionPool,
    RESTClient,
    _WATCH_RESUME_ATTEMPTS,
)
from kubernetes_tpu_torch.apiserver.frontend import (
    FollowerReadStore,
    serve_frontend,
)
from kubernetes_tpu_torch.apiserver.rest import serve
from kubernetes_tpu_torch.apiserver.watchcodec import WATCH_CONTENT_TYPE
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.runtime.consensus import QuorumLost
from kubernetes_tpu_torch.runtime.watch import BOOKMARK
from kubernetes_tpu_torch.testing.netchaos import LoadBalancerProxy
from kubernetes_tpu_torch.utils.metrics import metrics


def make_pod_serving(name, ns="default"):
    return Pod(
        metadata=ObjectMeta(name=name, namespace=ns),
        spec=PodSpec(containers=[Container(requests={"cpu": "1m"})]),
    )


def wait_until(cond, timeout=10.0, tick=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


@pytest.fixture
def rest():
    srv, port, store = serve(port=0, bookmark_period_s=0.5)
    client = RESTClient(f"http://127.0.0.1:{port}", timeout=5.0)
    yield client, store, port
    client.close()
    srv.shutdown()


# -- connection pool ----------------------------------------------------------


def test_pool_reuses_one_connection_across_requests(rest):
    client, _store, _port = rest
    opened0 = metrics.counter(COUNTER_CONN_OPENED)
    reused0 = metrics.counter(COUNTER_CONN_REUSED)
    for i in range(8):
        client.create("pods", make_pod_serving(f"pool-{i}"))
    objs, _ = client.list("pods")
    assert len(objs) == 8
    # one socket carried everything after the first request opened it
    assert metrics.counter(COUNTER_CONN_OPENED) - opened0 == 1
    assert metrics.counter(COUNTER_CONN_REUSED) - reused0 == 8
    assert client.pool.size() == 1


class _ScriptedServer:
    """Minimal raw HTTP/1.1 server for connection-lifecycle edges: each
    accepted connection serves requests until the per-connection script
    says close. Records every request line + body it actually SAW —
    the double-send assertions read this, not client-side state."""

    def __init__(
        self,
        close_after=1,
        status=201,
        body=b'{"ok":1}',
        blackhole_paths=(),
    ):
        self.close_after = close_after  # requests served per connection
        self.status = status
        self.body = body
        # paths whose request is READ (recorded) but never answered: the
        # connection closes instead — write delivered, ack lost
        self.blackhole_paths = blackhole_paths
        self.requests = []  # (method, path, body_bytes)
        self.connections = 0
        self._lock = threading.Lock()
        self._lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lst.bind(("127.0.0.1", 0))
        self._lst.listen(8)
        self.port = self._lst.getsockname()[1]
        self._stop = threading.Event()
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lst.accept()
            except OSError:
                return
            with self._lock:
                self.connections += 1
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _read_request(self, f):
        line = f.readline()
        if not line:
            return None
        method, path, _ = line.decode().split(" ", 2)
        length = 0
        while True:
            h = f.readline()
            if not h or h in (b"\r\n", b"\n"):
                break
            if h.lower().startswith(b"content-length:"):
                length = int(h.split(b":", 1)[1])
        body = f.read(length) if length else b""
        return method, path, body

    def _serve(self, conn):
        f = conn.makefile("rb")
        served = 0
        try:
            while served < self.close_after and not self._stop.is_set():
                req = self._read_request(f)
                if req is None:
                    return
                with self._lock:
                    self.requests.append(req)
                served += 1
                if any(p in req[1].encode() for p in self.blackhole_paths):
                    return  # delivered but unanswered: close in finally
                conn.sendall(
                    b"HTTP/1.1 %d X\r\nContent-Type: application/json\r\n"
                    b"Content-Length: %d\r\n\r\n%s"
                    % (self.status, len(self.body), self.body)
                )
        except OSError:
            pass
        finally:
            # FIN-close after the scripted request count: the pooled
            # client socket is now stale
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._lst.close()
        except OSError:
            pass


def test_stale_pooled_socket_reopens_once_and_never_double_sends_bind():
    """The server closes the kept-alive socket while it idles in the
    pool; the next bind must detect the pending EOF at acquire, open ONE
    fresh connection, and the server must see the bind exactly once."""
    server = _ScriptedServer(close_after=1)
    client = RESTClient(f"http://127.0.0.1:{server.port}", timeout=5.0)
    try:
        client._request("GET", client._url("pods", ""))  # pools the socket
        assert wait_until(lambda: client.pool.size() == 1, 2.0)
        # server has FIN-closed it by now (close_after=1); give the FIN
        # a moment to land so the stale check is deterministic
        assert wait_until(lambda: server.connections == 1, 2.0)
        time.sleep(0.05)
        opened0 = metrics.counter(COUNTER_CONN_OPENED)
        b = Binding(pod_name="p", pod_namespace="default", target_node="n1")
        client.bind_pods([b])
        binds = [r for r in server.requests if r[1].endswith("/binding")]
        assert len(binds) == 1, f"bind sent {len(binds)} times"
        assert metrics.counter(COUNTER_CONN_OPENED) - opened0 == 1
        assert server.connections == 2
    finally:
        client.close()
        server.stop()


def test_reused_conn_dying_mid_bind_post_classifies_quorum_lost():
    """The reused connection delivers the bind and dies before any
    response (the server read it, then closed) — outcome unknown, so the
    ONLY honest result is QuorumLost (read back before retry), never a
    transparent resend."""
    server = _ScriptedServer(
        close_after=99, blackhole_paths=(b"/binding",)
    )
    client = RESTClient(f"http://127.0.0.1:{server.port}", timeout=5.0)
    try:
        client._request("GET", client._url("pods", ""))  # pools the socket
        assert wait_until(lambda: server.connections == 1, 2.0)
        b = Binding(pod_name="p", pod_namespace="default", target_node="n1")
        errs = client.bind_pods([b])
        assert isinstance(errs[0], QuorumLost), errs
        binds = [r for r in server.requests if r[1].endswith("/binding")]
        assert len(binds) == 1  # delivered once, NEVER re-sent
        assert server.connections == 1  # the bind rode the reused socket
    finally:
        client.close()
        server.stop()


def test_reused_conn_dying_awaiting_get_response_retries_transparently(
    monkeypatch,
):
    """Same stale-socket race on an idempotent GET: one transparent
    reopen, the caller never sees the dead socket."""
    monkeypatch.setattr(
        HTTPConnectionPool, "_stale", staticmethod(lambda conn: False)
    )
    server = _ScriptedServer(close_after=1, body=b'{"items": []}')
    client = RESTClient(f"http://127.0.0.1:{server.port}", timeout=5.0)
    try:
        client._request("GET", client._url("pods", ""))
        assert wait_until(lambda: server.connections == 1, 2.0)
        time.sleep(0.05)
        out = client._request("GET", client._url("pods", ""))
        assert out == {"items": []}
        assert server.connections == 2  # exactly one reopen
    finally:
        client.close()
        server.stop()


def test_text_subresources_share_request_plumbing_and_degraded_retry():
    """get_text rides _request_raw now: a degraded-store 503 with
    Retry-After is transparently retried instead of surfacing a raw
    RuntimeError (the old hand-rolled error path skipped the contract)."""
    hits = []

    class _Flaky(_ScriptedServer):
        def _serve(self, conn):
            f = conn.makefile("rb")
            try:
                while True:
                    req = self._read_request(f)
                    if req is None:
                        return
                    hits.append(req)
                    if len(hits) == 1:
                        payload = json.dumps(
                            {"reason": "Degraded", "message": "quorum lost"}
                        ).encode()
                        conn.sendall(
                            b"HTTP/1.1 503 X\r\nRetry-After: 0\r\n"
                            b"Content-Length: %d\r\n\r\n%s"
                            % (len(payload), payload)
                        )
                    else:
                        conn.sendall(
                            b"HTTP/1.1 200 X\r\nContent-Type: text/plain\r\n"
                            b"Content-Length: 5\r\n\r\nhello"
                        )
            except OSError:
                pass

    server = _Flaky()
    client = RESTClient(f"http://127.0.0.1:{server.port}", timeout=5.0)
    try:
        text = client.get_text("pods", "default", "p/log")
        assert text == "hello"
        assert len(hits) == 2  # one 503, one retried success
    finally:
        client.close()
        server.stop()


# -- watch codec --------------------------------------------------------------


def test_binary_watch_codec_negotiated_and_decodes(rest):
    client, store, _port = rest
    store.create("pods", make_pod_serving("bin-1"))
    resp, conn = client._open_watch("pods", 0)
    try:
        assert WATCH_CONTENT_TYPE in (resp.headers.get("Content-Type") or "")
    finally:
        client._discard(conn)
    w = client.watch("pods", from_version=0)
    ev = None
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        ev = w.get(timeout=0.5)
        if ev is not None and ev.type != BOOKMARK:
            break
    assert ev is not None and ev.object.metadata.name == "bin-1"
    w.stop()


def test_codec_negotiation_falls_back_to_json_against_old_server():
    """A server that ignores the Accept offer answers newline-JSON; the
    client must branch on the RESPONSE Content-Type and decode the
    legacy wire."""
    event = {
        "type": "ADDED",
        "object": codec.encode(make_pod_serving("old-wire")),
    }
    line = json.dumps(event).encode() + b"\n"

    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]

    def old_server():
        conn, _ = lst.accept()
        f = conn.makefile("rb")
        while True:
            h = f.readline()
            if not h or h in (b"\r\n", b"\n"):
                break
        conn.sendall(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
        )
        conn.sendall(b"%x\r\n%s\r\n" % (len(line), line))
        time.sleep(1.0)
        conn.close()

    threading.Thread(target=old_server, daemon=True).start()
    client = RESTClient(f"http://127.0.0.1:{port}", timeout=5.0)
    try:
        w = client.watch("pods", from_version=0)
        ev = w.get(timeout=5.0)
        assert ev is not None and ev.object.metadata.name == "old-wire"
        w.stop()
    finally:
        client.close()
        lst.close()


def test_kind_resource_version_probe_is_kind_scoped(rest):
    client, store, _port = rest
    client.create("pods", make_pod_serving("krv-1"))
    pods_rv = store.kind_resource_version("pods")
    # another kind's writes advance the GLOBAL rv but not pods' kind rv
    from kubernetes_tpu_torch.api.objects import ConfigMap

    client.create(
        "configmaps",
        ConfigMap(metadata=ObjectMeta(name="cm"), data={"a": "b"}),
    )
    assert client.kind_resource_version("pods") == pods_rv
    assert client.kind_resource_version("pods") < store.resource_version


# -- balancer + frontends -----------------------------------------------------


def test_watch_through_balancer_resumes_on_frontend_death(rest):
    """Kill the frontend serving a watch stream: the client pump must
    resume through the balancer onto the surviving frontend, whose watch
    cache replays the gap — the consumer-visible Watcher never stops and
    every event arrives exactly once."""
    _client, store, pport = rest
    primary_url = f"http://127.0.0.1:{pport}"
    fe1, p1, c1 = serve_frontend(primary_url, bookmark_period_s=0.3)
    fe2, p2, c2 = serve_frontend(primary_url, bookmark_period_s=0.3)
    lb = LoadBalancerProxy(
        [("127.0.0.1", p1), ("127.0.0.1", p2)], retry_cooldown_s=0.2
    ).start()
    client = RESTClient(f"http://127.0.0.1:{lb.port}", timeout=5.0)
    try:
        store.create("pods", make_pod_serving("lb-0"))
        w = client.watch("pods", from_version=0)
        assert wait_until(
            lambda: (lambda e: e is not None and e.type != BOOKMARK)(
                w.get(timeout=0.2)
            ),
            5.0,
        )
        # find which backend carries the stream and kill that frontend
        per = lb.connections_per_backend()
        assert per, "no live relayed connection"
        backend = max(per, key=per.get)
        victim, survivor = (
            (fe1, fe2) if backend[1] == p1 else (fe2, fe1)
        )
        reconnects0 = sum(
            metrics.counter(COUNTER_WATCH_RECONNECTS, {"reason": r})
            for r in ("error", "eof", "truncated")
        )
        victim.shutdown()
        victim.server_close()
        store.create("pods", make_pod_serving("lb-after-kill"))
        seen = []

        def saw_new():
            ev = w.get(timeout=0.2)
            if ev is not None and ev.type != BOOKMARK:
                seen.append(ev.object.metadata.name)
            return "lb-after-kill" in seen

        assert wait_until(saw_new, 15.0), f"saw only {seen}"
        assert not w.stopped  # the consumer never observed the death
        assert (
            sum(
                metrics.counter(COUNTER_WATCH_RECONNECTS, {"reason": r})
                for r in ("error", "eof", "truncated")
            )
            > reconnects0
        )
        assert seen.count("lb-after-kill") == 1
        w.stop()
        survivor.shutdown()
        survivor.server_close()
    finally:
        client.close()
        c1.close()
        c2.close()
        lb.stop()


def test_poison_watch_stream_stops_after_bounded_resumes():
    """A stream that dies on an undecodable event at a fixed rv must NOT
    reconnect at full speed forever: _open_watch succeeds every time (the
    server is healthy), so the connect backoff never engages — the pump
    must bound consecutive zero-progress resumes, then stop the watcher
    so the consumer takes its relist path."""
    server = _ScriptedServer(close_after=1, status=200, body=b"not-json\n")
    client = RESTClient(f"http://127.0.0.1:{server.port}", timeout=5.0)
    try:
        w = client.watch("pods", from_version=0)
        assert wait_until(lambda: w.stopped, 10.0), "pump never gave up"
        watches = [r for r in server.requests if "watch=1" in r[1]]
        assert 1 < len(watches) <= 1 + _WATCH_RESUME_ATTEMPTS, (
            f"expected bounded resumes, server saw {len(watches)} opens"
        )
    finally:
        client.close()
        server.stop()


# -- follower reads -----------------------------------------------------------


class _StubFollower:
    """Deterministic follower replica for freshness-wait edges: the test
    drives applies and commit advances by hand."""

    def __init__(self):
        self.objects = {}
        self.rv = 0
        self.commit_index = 0
        self._obs = []

    def register_observer(self, obs):
        self._obs.append(obs)

    def list_kind(self, kind):
        d = self.objects.get(kind, {})
        return [copy.deepcopy(o) for o in d.values()], self.rv

    def wait_commit(self, rv, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.commit_index >= rv:
                return True
            time.sleep(0.01)
        return self.commit_index >= rv

    # test drivers ----------------------------------------------------------
    def apply(self, verb, kind, obj):
        self.rv += 1
        obj = copy.deepcopy(obj)
        obj.metadata.resource_version = self.rv
        d = self.objects.setdefault(kind, {})
        if verb == "delete":
            d.pop(obj.metadata.key, None)
        else:
            d[obj.metadata.key] = obj
        for o in self._obs:
            o.on_records([(self.rv, verb, kind, copy.deepcopy(obj))])
        return self.rv

    def commit(self, c):
        self.commit_index = c
        for o in self._obs:
            o.on_commit(c)


class _StubPrimary:
    def __init__(self):
        self.kind_rv = 0

    def kind_resource_version(self, kind):
        return self.kind_rv


def test_follower_read_withholds_uncommitted_events():
    follower = _StubFollower()
    primary = _StubPrimary()
    frs = FollowerReadStore(follower, primary)
    w = frs.watch("pods", from_version=0)
    follower.apply("create", "pods", make_pod_serving("unc-1"))
    assert w.get(timeout=0.2) is None  # applied but NOT committed
    follower.commit(1)
    ev = w.get(timeout=2.0)
    assert ev is not None and ev.object.metadata.name == "unc-1"
    # the list label never runs ahead of the commit index
    follower.apply("create", "pods", make_pod_serving("unc-2"))
    objs, rv = frs.list("pods")
    assert rv == 1 and len(objs) == 2  # state fresh, label committed


def test_follower_consistent_list_blocks_then_serves_on_commit():
    """A consistent (limit) list demanding the primary's kind rv blocks
    while the follower's commit index is behind, then serves the moment
    the commit catches up — the cacher's wait_until_fresh seam generalized
    to the commit index."""
    follower = _StubFollower()
    primary = _StubPrimary()
    frs = FollowerReadStore(follower, primary)
    srv, port, _ = serve(store=frs, port=0, bookmark_period_s=0.5)
    client = RESTClient(f"http://127.0.0.1:{port}", timeout=20.0)
    try:
        follower.apply("create", "pods", make_pod_serving("f-1"))
        follower.commit(1)
        follower.apply("create", "pods", make_pod_serving("f-2"))  # rv 2 uncommitted
        primary.kind_rv = 2  # the primary has acked rv 2: clients demand it
        result = {}

        def consistent_list():
            t0 = time.monotonic()
            out = client._request("GET", client._url("pods", "") + "?limit=10")
            result["elapsed"] = time.monotonic() - t0
            result["out"] = out

        t = threading.Thread(target=consistent_list, daemon=True)
        t.start()
        time.sleep(0.4)
        assert "out" not in result, "served before the commit covered rv 2"
        follower.commit(2)
        t.join(timeout=10.0)
        assert "out" in result
        assert int(result["out"]["metadata"]["resourceVersion"]) >= 2
        names = {i["metadata"]["name"] for i in result["out"]["items"]}
        assert names == {"f-1", "f-2"}
        assert result["elapsed"] >= 0.3  # it genuinely waited
    finally:
        client.close()
        srv.shutdown()


def test_follower_consistent_list_times_out_504_with_retry_after():
    follower = _StubFollower()
    primary = _StubPrimary()
    frs = FollowerReadStore(follower, primary)
    srv, port, _ = serve(
        store=frs, port=0, bookmark_period_s=0.5, freshness_timeout_s=1.0
    )
    client = RESTClient(f"http://127.0.0.1:{port}", timeout=20.0)
    try:
        follower.apply("create", "pods", make_pod_serving("t-1"))
        follower.commit(1)
        primary.kind_rv = 99  # demanded rv the follower will never reach
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/pods?limit=10"
        )
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=20.0)
        assert exc.value.code == 504
        assert exc.value.headers.get("Retry-After") is not None
    finally:
        client.close()
        srv.shutdown()


def test_follower_rv0_list_serves_stale_without_waiting():
    """resourceVersion=0 keeps the reference semantics on followers too:
    'give me what you have' never blocks on freshness."""
    follower = _StubFollower()
    primary = _StubPrimary()
    frs = FollowerReadStore(follower, primary)
    srv, port, _ = serve(store=frs, port=0, bookmark_period_s=0.5)
    client = RESTClient(f"http://127.0.0.1:{port}", timeout=5.0)
    try:
        follower.apply("create", "pods", make_pod_serving("rv0-1"))
        follower.commit(1)
        primary.kind_rv = 99  # far ahead: rv=0 must not care
        out = client._request(
            "GET", client._url("pods", "") + "?resourceVersion=0"
        )
        assert [i["metadata"]["name"] for i in out["items"]] == ["rv0-1"]
    finally:
        client.close()
        srv.shutdown()


def test_follower_snapshot_reset_terminates_watchers():
    follower = _StubFollower()
    frs = FollowerReadStore(follower, _StubPrimary())
    w = frs.watch("pods", from_version=0)
    follower.apply("create", "pods", make_pod_serving("s-1"))
    follower.commit(1)
    assert w.get(timeout=1.0) is not None
    for o in follower._obs:
        o.on_snapshot()
    assert wait_until(lambda: w.stopped, 2.0)


# -- tests/test_chaos_net.py -------------------------------------------
# Network & process chaos: the control plane over REAL sockets and REAL
# OS processes, through the deterministic NetChaosProxy
# (kubernetes_tpu/testing/netchaos.py).
#
# Every prior chaos suite runs in one process against a ChaosStore; these
# scenarios exercise the failure modes only a deployed control plane sees
# — and prove the replication guarantees:
#
#   * a **blackholed bind ack** (write applied, response dropped) surfaces
#     as QuorumLost and the read-back reconciler resolves it: the pod
#     ends bound EXACTLY once, never blindly replayed, never lost;
#   * a **mid-request reset** (request never reached the server) parks the
#     placement and the reconciler's uid-fenced replay binds it once;
#   * a **full partition** (ECONNREFUSED) blinds the scheduler; informers
#     recover on heal and everything binds exactly once;
#   * a **slow, jittery, bandwidth-capped network** binds everything with
#     zero duplicate applies;
#   * a **half-open watch stream** (client vanished without FIN) is reaped
#     by the REST bookmark heartbeat;
#   * in the **multi-process REST topology** (API server, leader, standby
#     as separate OS processes), partitioning or SIGSTOPping the leader
#     promotes the standby, and the healed/resumed zombie's late REST
#     binds are rejected with LeaderFenced — zero double-binds on the
#     cross-process JSONL ledger.
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import pytest


from kubernetes_tpu_torch.api.objects import (
    Binding,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.apiserver.client import RESTClient
from kubernetes_tpu_torch.apiserver.rest import serve
from kubernetes_tpu_torch.runtime.consensus import DegradedWrites, QuorumLost
from kubernetes_tpu_torch.testing.netchaos import (
    NetChaosProxy,
    sigcont,
    sigkill,
    sigstop,
)
from kubernetes_tpu_torch.utils.metrics import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the helpers tests/test_chaos_pipeline.py gives the reference's file
def wait_until(fn, timeout=60.0, period=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def make_pod(name, cpu="100m", labels=None):
    return Pod(
        metadata=ObjectMeta(name=name, labels=labels or {}),
        spec=PodSpec(containers=[Container(requests={"cpu": cpu})]),
    )


def make_node(name, cpu="8"):
    return Node(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": 110}
        ),
    )


# -- proxy semantics (fast: tier-1 coverage of the harness itself) ------------


# -- scheduler-through-proxy scenarios ---------------------------------------


# -- multi-process topology ---------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Proc:
    """One child process with line-captured stdout (READY handshake) and
    stderr spooled to a file (log-heavy children must not deadlock on a
    full pipe)."""

    def __init__(self, args, tag):
        self.tag = tag
        self.errfile = tempfile.NamedTemporaryFile(
            "w+", prefix=f"netchaos-{tag}-", suffix=".log", delete=False
        )
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.testing.netchaos_procs",
             *args],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=self.errfile,
            text=True,
            env=env,
        )
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.strip())

    def wait_ready(self, timeout=60.0) -> str:
        assert wait_until(
            lambda: any(l.startswith("READY") for l in self.lines)
            or self.proc.poll() is not None,
            timeout,
        ), f"{self.tag} never became ready"
        ready = [l for l in self.lines if l.startswith("READY")]
        if not ready:
            self.errfile.flush()
            with open(self.errfile.name) as fh:
                raise AssertionError(
                    f"{self.tag} exited rc={self.proc.returncode}:\n"
                    + fh.read()[-3000:]
                )
        return ready[0]

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except Exception:
            pass


def _status(port: int) -> dict:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/status", timeout=5
    ) as r:
        return json.loads(r.read())


def _force_bind(port: int, name: str, node: str, uid: str = "") -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/bind",
        data=json.dumps({"name": name, "node": node, "uid": uid}).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _ledger_applied(path: str) -> Counter:
    applied = Counter()
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["event"] == "applied":
                applied[rec["uid"]] += 1
    return applied


def _ledger_fenced_identities(path: str) -> list:
    out = []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["event"] == "fenced":
                out.append(rec["identity"])
    return out


def _ledger_records(path: str, event: str) -> list:
    with open(path) as fh:
        return [
            rec
            for rec in (json.loads(line) for line in fh)
            if rec["event"] == event
        ]


def _get_trace(port: int, trace_id: str) -> dict:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/traces?id={trace_id}", timeout=5
    ) as r:
        return json.loads(r.read())


class _MultiProc:
    """apiserver + leader + standby as real OS processes. The leader
    talks REST through a NetChaosProxy; the standby and the test talk
    straight to the API server."""

    def __init__(self, leader_zombie_hold=True, leader_via_proxy=True):
        self.api_port = _free_port()
        self.ledger = tempfile.NamedTemporaryFile(
            "w", prefix="netchaos-ledger-", suffix=".jsonl", delete=False
        ).name
        self.procs = []
        self.api = self._spawn(
            ["apiserver", "--port", str(self.api_port),
             "--ledger", self.ledger],
            "apiserver",
        )
        self.api.wait_ready()
        self.direct_url = f"http://127.0.0.1:{self.api_port}"
        self.client = RESTClient(self.direct_url, timeout=5.0)
        self.proxy = None
        leader_url = self.direct_url
        if leader_via_proxy:
            self.proxy = NetChaosProxy("127.0.0.1", self.api_port).start()
            leader_url = f"http://127.0.0.1:{self.proxy.port}"
        self.leader_debug = _free_port()
        leader_args = [
            "scheduler", "--server", leader_url, "--identity", "lead-a",
            "--platform", "cpu",
            "--debug-port", str(self.leader_debug),
        ]
        if leader_zombie_hold:
            leader_args.append("--zombie-hold")
        self.leader = self._spawn(leader_args, "leader")
        self.leader.wait_ready(120)
        assert wait_until(
            lambda: _status(self.leader_debug)["promoted"], 60
        ), "first replica never promoted"
        self.standby_debug = _free_port()
        self.standby = self._spawn(
            ["scheduler", "--server", self.direct_url, "--platform", "cpu",
             "--identity", "stand-b",
             "--debug-port", str(self.standby_debug)],
            "standby",
        )
        self.standby.wait_ready(120)

    def _spawn(self, args, tag):
        p = _Proc(args, tag)
        self.procs.append(p)
        return p

    def all_bound(self, n: int) -> bool:
        pods, _ = self.client.list("pods")
        return sum(1 for p in pods if p.spec.node_name) >= n

    def stop(self):
        if self.proxy is not None:
            self.proxy.stop()
        for p in self.procs:
            p.kill()


@pytest.mark.slow
def test_multiproc_partition_promote_heal_zombie_rest_binds_fenced():
    """THE acceptance scenario, over real processes and real sockets:
    partition the leader mid-wave -> the standby promotes and binds
    everything -> heal -> the zombie's late REST binds (it kept its
    scheduling loops: --zombie-hold) are rejected with LeaderFenced —
    and the cross-process ledger shows every pod applied exactly once."""
    mp = _MultiProc(leader_zombie_hold=True, leader_via_proxy=True)
    try:
        for i in range(4):
            mp.client.create("nodes", make_node(f"net-{i}"))
        for i in range(10):
            mp.client.create("pods", make_pod(f"wave1-{i}"))
        assert wait_until(lambda: mp.all_bound(10), 60), (
            "leader never bound the first wave"
        )
        # partition the leader mid-operation: its renews AND binds now
        # fail fast (ECONNREFUSED through its proxy)
        mp.proxy.partition("refuse")
        assert wait_until(
            lambda: _status(mp.standby_debug)["promoted"], 60
        ), "standby never promoted after the partition"
        # the second wave lands while the zombie is cut off
        for i in range(10):
            mp.client.create("pods", make_pod(f"wave2-{i}"))
        assert wait_until(lambda: mp.all_bound(20), 60), (
            "standby never bound the second wave"
        )
        mp.proxy.heal()
        # the healed zombie still holds its stale fence (zombie-hold kept
        # its loops alive): drive one late REST bind through its own
        # fence-attaching seam — the server must reject it
        target = mp.client.create("pods", make_pod("late-target"))
        out = _force_bind(
            mp.leader_debug, "late-target", "net-0", target.metadata.uid
        )
        assert out["result"] == "LeaderFenced", out
        # the pod the zombie tried to steal is untouched by that attempt
        # and the new leader binds it
        assert wait_until(lambda: mp.all_bound(21), 60)
        applied = _ledger_applied(mp.ledger)
        assert applied and all(c == 1 for c in applied.values()), (
            f"double-applied binds: { {k: v for k, v in applied.items() if v != 1} }"
        )
        assert "lead-a" in _ledger_fenced_identities(mp.ledger), (
            "the zombie's fenced bind never reached the ledger"
        )
        # the zombie counted its rejection (path=rest)
        assert _status(mp.leader_debug)["fenced_binds"] >= 1
    finally:
        mp.stop()


@pytest.mark.slow
def test_multiproc_trace_ids_survive_rest_hop():
    """Trace propagation: a trace id minted in the LEADER process (at
    queue admission) crosses the REST /binding hop in X-Trace-Context
    and appears in the store process's JSONL ledger — for normal binds
    AND for a fenced zombie bind — and resolves back to a complete
    per-pod trace on the leader's debug port."""
    mp = _MultiProc(leader_zombie_hold=True, leader_via_proxy=False)
    try:
        for i in range(4):
            mp.client.create("nodes", make_node(f"net-{i}"))
        for i in range(6):
            mp.client.create("pods", make_pod(f"traced-{i}"))
        assert wait_until(lambda: mp.all_bound(6), 60)
        applied = _ledger_records(mp.ledger, "applied")
        assert len(applied) == 6
        # every apply record carries the scheduler-minted trace id
        for rec in applied:
            assert rec.get("trace"), f"untraced apply record: {rec}"
        # ... and the id resolves to a COMPLETE trace in the leader: the
        # store's view and the scheduler's view agree on identity
        tid = applied[0]["trace"]
        trace = _get_trace(mp.leader_debug, tid)
        assert trace["trace_id"] == tid and trace["finished"], trace
        assert trace["outcome"] == "bound"
        assert "bind" in trace["stages_ms"] and "queue" in trace["stages_ms"]
        # zombie path: freeze the leader through lease expiry, promote
        # the standby, resume — the zombie's late REST bind is fenced
        # and the ledger's fence record carries ITS trace id
        sigstop(mp.leader.proc)
        assert wait_until(
            lambda: _status(mp.standby_debug)["promoted"], 60
        ), "standby never promoted after SIGSTOP"
        sigcont(mp.leader.proc)
        target = mp.client.create("pods", make_pod("traced-late"))
        out = _force_bind(
            mp.leader_debug, "traced-late", "net-0", target.metadata.uid
        )
        assert out["result"] == "LeaderFenced", out
        assert out.get("trace"), "forced bind minted no trace"
        assert wait_until(
            lambda: bool(_ledger_records(mp.ledger, "fenced")), 30
        ), "the zombie's fenced bind never reached the ledger"
        fenced = _ledger_records(mp.ledger, "fenced")
        assert any(
            out["trace"] in rec.get("traces", []) for rec in fenced
        ), (out["trace"], fenced)
        # the fenced trace is inspectable in the zombie process too
        ztrace = _get_trace(mp.leader_debug, out["trace"])
        assert ztrace["outcome"] == "fenced", ztrace
    finally:
        mp.stop()


@pytest.mark.slow
def test_multiproc_sigstop_zombie_resumes_into_the_fence():
    """Process chaos: SIGSTOP freezes the leader through its lease
    expiry (the canonical GC-pause/zombie shape); the standby promotes;
    SIGCONT resumes the zombie, whose late REST binds carry the stale
    fence and are rejected. Exactly-once on the ledger throughout."""
    mp = _MultiProc(leader_zombie_hold=True, leader_via_proxy=False)
    try:
        for i in range(4):
            mp.client.create("nodes", make_node(f"net-{i}"))
        for i in range(6):
            mp.client.create("pods", make_pod(f"pre-stop-{i}"))
        assert wait_until(lambda: mp.all_bound(6), 60)
        sigstop(mp.leader.proc)
        assert wait_until(
            lambda: _status(mp.standby_debug)["promoted"], 60
        ), "standby never promoted after SIGSTOP"
        for i in range(6):
            mp.client.create("pods", make_pod(f"mid-stop-{i}"))
        assert wait_until(lambda: mp.all_bound(12), 60)
        sigcont(mp.leader.proc)
        target = mp.client.create("pods", make_pod("zombie-late"))
        out = _force_bind(
            mp.leader_debug, "zombie-late", "net-1", target.metadata.uid
        )
        assert out["result"] == "LeaderFenced", out
        assert wait_until(lambda: mp.all_bound(13), 60)
        applied = _ledger_applied(mp.ledger)
        assert applied and all(c == 1 for c in applied.values()), (
            f"double-applied binds: { {k: v for k, v in applied.items() if v != 1} }"
        )
        assert "lead-a" in _ledger_fenced_identities(mp.ledger)
        # SIGKILL epilogue: hard-kill the zombie; the survivors are
        # unaffected (the new leader keeps binding)
        sigkill(mp.leader.proc)
        mp.client.create("pods", make_pod("post-kill"))
        assert wait_until(lambda: mp.all_bound(14), 60)
    finally:
        mp.stop()


# -- tests/test_chaos_serving.py ---------------------------------------
# Serving-tier chaos: the multi-process frontend/follower fleet under
# sustained mixed read/write traffic while members are killed mid-storm.
#
# Topology (all REAL OS processes except the in-test balancer):
#
#     clients -> LoadBalancerProxy -> [frontend-1, frontend-2, follower-A]
#                                          |             |          |
#                                          +--- REST ----+----------+--> primary
#                                                              (repl) --> follower-A
#                                                                     --> follower-B
#
# The primary runs a consensus ReplicationListener (cluster_size=3) and a
# JSONL LedgerStore; follower-A serves commit-gated reads over REST
# (apiserver/frontend.FollowerReadStore), follower-B is a quorum peer.
# Mid-storm, frontend-1 AND follower-A are SIGKILLed. Acceptance:
#
#   * zero acked-write loss: every create/bind the client saw acked is in
#     the surviving store, binds applied exactly once on the ledger;
#   * zero stale-served consistent reads: every consistent (limit) list
#     through the balancer contains every write acked BEFORE the list was
#     issued — no matter which backend served it;
#   * watchers resume through the balancer with zero relists: the client
#     watch pump reconnects onto a surviving frontend whose cache replays
#     the gap — consumer-visible Watchers never stop, every pod's ADDED
#     arrives exactly once.
import json
import threading
import time
import urllib.error
from collections import Counter

import pytest


from kubernetes_tpu_torch.api.objects import (
    Binding,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.apiserver.client import RESTClient
from kubernetes_tpu_torch.runtime.consensus import DegradedWrites, QuorumLost
from kubernetes_tpu_torch.runtime.watch import ADDED, BOOKMARK
from kubernetes_tpu_torch.testing.netchaos import LoadBalancerProxy, sigkill


def make_pod_fleet(name):
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=PodSpec(containers=[Container(requests={"cpu": "1m"})]),
    )


def make_node_fleet(name):
    return Node(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=NodeSpec(),
        status=NodeStatus(
            allocatable={"cpu": "64", "memory": "256Gi", "pods": 500}
        ),
    )


class _Fleet:
    """primary(+repl+ledger) / follower-A(read REST) / follower-B(quorum)
    / two stateless frontends, one in-test balancer over the read tier."""

    def __init__(self, tmp_path):
        self.ledger = str(tmp_path / "serving_ledger.jsonl")
        api_port = _free_port()
        self.procs = {}
        self.procs["primary"] = _Proc(
            [
                "apiserver",
                "--port", str(api_port),
                "--ledger", self.ledger,
                "--repl-port", "0",
                "--cluster-size", "3",
            ],
            "primary",
        )
        ready = self.procs["primary"].wait_ready().split()
        self.primary_port, self.repl_port = int(ready[2]), int(ready[3])
        self.primary_url = f"http://127.0.0.1:{self.primary_port}"
        self.procs["follower-a"] = _Proc(
            [
                "follower",
                "--primary", self.primary_url,
                "--repl-port", str(self.repl_port),
                "--node-id", "1",
            ],
            "follower-a",
        )
        self.procs["follower-b"] = _Proc(
            [
                "follower",
                "--primary", self.primary_url,
                "--repl-port", str(self.repl_port),
                "--node-id", "2",
            ],
            "follower-b",
        )
        self.procs["frontend-1"] = _Proc(
            ["frontend", "--primary", self.primary_url], "frontend-1"
        )
        self.procs["frontend-2"] = _Proc(
            ["frontend", "--primary", self.primary_url], "frontend-2"
        )
        self.follower_a_port = int(
            self.procs["follower-a"].wait_ready().split()[2]
        )
        self.procs["follower-b"].wait_ready()
        self.fe1_port = int(self.procs["frontend-1"].wait_ready().split()[2])
        self.fe2_port = int(self.procs["frontend-2"].wait_ready().split()[2])
        self.balancer = LoadBalancerProxy(
            [
                ("127.0.0.1", self.fe1_port),
                ("127.0.0.1", self.fe2_port),
                ("127.0.0.1", self.follower_a_port),
            ],
            retry_cooldown_s=0.3,
        ).start()
        self.url = f"http://127.0.0.1:{self.balancer.port}"

    def client(self, timeout=10.0) -> RESTClient:
        return RESTClient(self.url, timeout=timeout)

    def stop(self):
        self.balancer.stop()
        for p in self.procs.values():
            p.kill()

    def ledger_applied(self) -> Counter:
        applied = Counter()
        with open(self.ledger) as fh:
            for line in fh:
                rec = json.loads(line)
                if rec.get("event") == "applied":
                    applied[rec["uid"] or rec.get("name", "")] += 1
        return applied


@pytest.fixture
def fleet(tmp_path):
    f = _Fleet(tmp_path)
    yield f
    f.stop()


@pytest.mark.slow
def test_fleet_serves_reads_and_routes_writes(fleet):
    """Sanity before chaos: writes through ANY balancer backend land on
    the primary; rv=0 and consistent lists serve from every backend's
    cache/replica at the primary's kind rv."""
    c = fleet.client()
    for i in range(6):
        c.create("pods", make_pod_fleet(f"sanity-{i}"))
    # every backend, asked directly, serves the consistent view
    for port in (fleet.fe1_port, fleet.fe2_port, fleet.follower_a_port):
        cc = RESTClient(f"http://127.0.0.1:{port}", timeout=10.0)
        out = cc._request("GET", cc._url("pods", "") + "?limit=50")
        names = {i["metadata"]["name"] for i in out["items"]}
        assert names == {f"sanity-{i}" for i in range(6)}, (port, names)
        cc.close()
    # and a watch through the balancer replays current state
    w = c.watch("pods", from_version=0)
    seen = set()

    def replayed():
        ev = w.get(timeout=0.2)
        if ev is not None and ev.type == ADDED:
            seen.add(ev.object.metadata.name)
        return len(seen) >= 6

    assert wait_until(replayed, 10.0), seen
    w.stop()
    c.close()


@pytest.mark.slow
def test_storm_kill_frontend_and_follower_mid_storm(fleet):
    """The acceptance storm: sustained mixed create/bind/consistent-list
    /watch traffic through the balancer while frontend-1 AND the
    read-serving follower are SIGKILLed."""
    N_PODS = 120
    KILL_AT = 35  # pods acked before the kill lands
    c = fleet.client()
    c.create("nodes", make_node_fleet("n1"))

    acked_lock = threading.Lock()
    acked_creates: dict = {}  # name -> rv at ack time
    acked_binds: set = set()
    stale_reads: list = []
    read_errors = [0]
    stop_readers = threading.Event()

    # -- watchers (before the storm: they must ride the kills) -----------
    watch_client = fleet.client()
    watchers = [watch_client.watch("pods", from_version=0) for _ in range(3)]
    watcher_names = [Counter() for _ in watchers]
    watcher_stop = threading.Event()

    def drain(w, names):
        while not watcher_stop.is_set():
            ev = w.get(timeout=0.2)
            if ev is not None and ev.type == ADDED:
                names[ev.object.metadata.name] += 1

    drain_threads = [
        threading.Thread(target=drain, args=(w, n), daemon=True)
        for w, n in zip(watchers, watcher_names)
    ]
    for t in drain_threads:
        t.start()

    # -- consistent readers ----------------------------------------------
    def reader():
        rc = fleet.client(timeout=15.0)
        while not stop_readers.is_set():
            with acked_lock:
                demanded = set(acked_creates)
            try:
                out = rc._request(
                    "GET", rc._url("pods", "") + "?limit=1000"
                )
            except (urllib.error.HTTPError, OSError, DegradedWrites):
                read_errors[0] += 1  # 504/transport during the kill: retry
                time.sleep(0.1)
                continue
            names = {i["metadata"]["name"] for i in out["items"]}
            missing = demanded - names
            if missing:
                stale_reads.append(sorted(missing))
            time.sleep(0.05)
        rc.close()

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(2)]
    for t in readers:
        t.start()

    # -- the write storm -------------------------------------------------
    killed = threading.Event()

    def create_one(name) -> bool:
        for _attempt in range(8):
            try:
                out = c.create("pods", make_pod_fleet(name))
                with acked_lock:
                    acked_creates[name] = out.metadata.resource_version
                return True
            except (DegradedWrites, OSError):
                time.sleep(0.15)
            except urllib.error.HTTPError:
                time.sleep(0.15)
        return False

    def bind_one(name) -> None:
        b = Binding(
            pod_name=name, pod_namespace="default", target_node="n1"
        )
        for _attempt in range(8):
            try:
                errs = c.bind_pods([b])
            except OSError:
                time.sleep(0.15)
                continue
            err = errs[0]
            if err is None:
                with acked_lock:
                    acked_binds.add(name)
                return
            if isinstance(err, QuorumLost):
                # outcome unknown: read back like the reconciler — if it
                # landed, it is acked-equivalent (the server applied it)
                try:
                    pod = c.get("pods", "default", name)
                    if pod.spec.node_name:
                        with acked_lock:
                            acked_binds.add(name)
                        return
                except Exception:
                    pass
                time.sleep(0.15)
            elif isinstance(err, DegradedWrites):
                time.sleep(0.15)
            else:
                return  # Conflict (already bound by an earlier attempt)

    for i in range(N_PODS):
        name = f"storm-{i}"
        if create_one(name):
            bind_one(name)
        if i == KILL_AT and not killed.is_set():
            sigkill(fleet.procs["frontend-1"].proc)
            sigkill(fleet.procs["follower-a"].proc)
            killed.set()

    assert killed.is_set()
    with acked_lock:
        assert len(acked_creates) >= N_PODS * 0.9, (
            f"storm mostly failed: {len(acked_creates)}/{N_PODS} acked"
        )

    # -- drain + verify ---------------------------------------------------
    stop_readers.set()
    for t in readers:
        t.join(timeout=5.0)

    # zero stale-served consistent reads
    assert not stale_reads, f"consistent reads missed acked writes: {stale_reads[:3]}"

    # zero acked-write loss: every acked create/bind is in the surviving
    # store (read via the healthy frontend, consistent)
    final = RESTClient(f"http://127.0.0.1:{fleet.fe2_port}", timeout=15.0)
    out = final._request("GET", final._url("pods", "") + "?limit=2000")
    by_name = {i["metadata"]["name"]: i for i in out["items"]}
    with acked_lock:
        missing = set(acked_creates) - set(by_name)
        assert not missing, f"acked creates lost: {sorted(missing)[:5]}"
        unbound = [
            n
            for n in acked_binds
            if not by_name[n]["spec"].get("nodeName")
        ]
        assert not unbound, f"acked binds lost: {unbound[:5]}"

    # binds applied exactly once on the cross-process ledger
    applied = fleet.ledger_applied()
    multi = {k: v for k, v in applied.items() if v > 1}
    assert not multi, f"double-applied binds: {multi}"

    # watchers rode the kills: never stopped (zero relists), and every
    # acked pod's ADDED arrived exactly once
    def watchers_caught_up():
        with acked_lock:
            want = set(acked_creates)
        return all(want <= set(names) for names in watcher_names)

    assert wait_until(watchers_caught_up, 30.0), (
        "watchers missed events: "
        + str(
            [
                sorted(set(acked_creates) - set(n))[:5]
                for n in watcher_names
            ]
        )
    )
    for w in watchers:
        assert not w.stopped, "a watcher died (relist would be forced)"
    for names in watcher_names:
        dups = {n: k for n, k in names.items() if k > 1}
        assert not dups, f"duplicate deliveries after resume: {dups}"
    watcher_stop.set()
    for w in watchers:
        w.stop()
    # the balancer routed around the corpses
    assert fleet.balancer.live_connections() >= 0  # (machinery intact)
    c.close()
    watch_client.close()
