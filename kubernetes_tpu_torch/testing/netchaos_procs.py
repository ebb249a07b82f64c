"""Child-process entries for the multi-process network-chaos suite (port).

PyTorch port of ``kubernetes_tpu/testing/netchaos_procs.py``. What
changed: the ``scheduler`` role takes ``--platform`` as
``cmd/scheduler.py`` does (``cpu`` runs the replica's Scheduler on the
CPU; any other value, or none, the CUDA card, raising without one before
the replica starts), and ``run_scheduler``/``_Replica`` take the
``device`` it names. The reference's replica runs ``use_device=False``
with no device; the port's Scheduler always resolves one, so the role
never falls back to the CPU unasked. Every other definition is the
reference's (``tests/test_torch_copies.py``). The reference's notes
follow.

`tests/test_chaos_net.py` runs the control plane as REAL OS processes —
API server, leader scheduler, standby scheduler — talking REST through a
NetChaosProxy, so partitions, SIGSTOP zombies, and lost responses hit
actual sockets and actual process boundaries (nothing in-process chaos
can fake). This module is what those children execute:

    python -m kubernetes_tpu_torch.testing.netchaos_procs apiserver \
        --port P --ledger /path/ledger.jsonl
    python -m kubernetes_tpu_torch.testing.netchaos_procs scheduler \
        --server http://127.0.0.1:PROXY --identity a --debug-port D \
        [--platform cpu] [--zombie-hold] [--lease-duration 1.5 ...]

The API-server child wraps its store in a **LedgerStore**: every bind
application and acknowledgment appends a JSONL record, and every
fence rejection is recorded with the rejected identity — the cross-
process equivalent of ChaosStore's in-memory ledger, so the test can
prove "every pod bound exactly once, every zombie bind fenced" from one
file regardless of which process did what.

The scheduler child wires a replica the way cmd/scheduler.py does
(standby first, the election winner promotes with the fence) and adds a
debug HTTP port: GET /status (role, counters) and POST /bind (drive one
binding through the replica's OWN fence-attaching seam — how the test
makes a resumed zombie attempt a late REST bind deterministically).
``--zombie-hold`` keeps the scheduling loops running after the elector
loses leadership: the deliberately misbehaving replica the fence exists
to stop (a well-behaved one shuts down, and then there is nothing left
to fence).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..device import DeviceLike, resolve_device

logger = logging.getLogger("kubernetes_tpu.testing.netchaos_procs")


# -- apiserver child ---------------------------------------------------------


def _ledger_store(ledger_path: str):
    """APIServer subclass appending bind outcomes to a JSONL ledger."""
    from ..client.apiserver import APIServer, LeaderFenced

    lock = threading.Lock()
    fh = open(ledger_path, "a", encoding="utf-8")

    from ..utils.tracing import trace_for_binding

    class LedgerStore(APIServer):
        def _ledger(self, record: dict) -> None:
            with lock:
                fh.write(json.dumps(record, separators=(",", ":")) + "\n")
                fh.flush()

        def bind_pods(self, bindings, fence=None):
            # trace context (re-established by the REST route from the
            # X-Trace-Context header) resolves per binding: the ledger
            # proves a scheduler-minted trace id survived the wire
            traces = {id(b): trace_for_binding(b) for b in bindings}
            try:
                errors = super().bind_pods(bindings, fence=fence)
            except LeaderFenced:
                self._ledger(
                    {
                        "event": "fenced",
                        "identity": getattr(fence, "identity", None),
                        "transitions": getattr(fence, "transitions", None),
                        "uids": [b.pod_uid for b in bindings],
                        "traces": [traces[id(b)] for b in bindings],
                    }
                )
                raise
            for b, err in zip(bindings, errors):
                if err is None:
                    # the in-process store applies and acks atomically;
                    # both records keep the ledger shape aligned with
                    # ChaosStore (applied_binds / acked_binds)
                    self._ledger(
                        {
                            "event": "applied",
                            "uid": b.pod_uid,
                            "name": f"{b.pod_namespace}/{b.pod_name}",
                            "node": b.target_node,
                            "trace": traces[id(b)],
                        }
                    )
                    self._ledger(
                        {
                            "event": "acked",
                            "uid": b.pod_uid,
                            "name": f"{b.pod_namespace}/{b.pod_name}",
                            "node": b.target_node,
                            "trace": traces[id(b)],
                        }
                    )
            return errors

    return LedgerStore()


def run_apiserver(
    port: int, ledger: str, repl_port: int = 0, cluster_size: int = 0
) -> None:
    from ..apiserver.rest import serve

    store = _ledger_store(ledger)
    repl_bound = 0
    if repl_port or cluster_size:
        # the serving-tier fleet: followers tail this listener and serve
        # commit-gated reads (apiserver/frontend.FollowerReadStore)
        from ..runtime.replication import ReplicationListener

        listener = ReplicationListener(
            port=repl_port, cluster_size=cluster_size or None
        )
        listener.attach(store)
        repl_bound = listener.address[1]
    srv, bound_port, _ = serve(store=store, port=port, bookmark_period_s=0.5)
    print(f"READY apiserver {bound_port} {repl_bound}", flush=True)
    threading.Event().wait()


# -- serving-tier children (frontend / follower) ------------------------------


class _BenchStatsHandler(BaseHTTPRequestHandler):
    """Tiny stats endpoint for the serving bench: the hollow-watcher
    drain pool's delivery latencies + counts, as JSON."""

    server_version = "serving-bench-stats"

    def log_message(self, *args):
        pass

    def do_GET(self):
        stats = self.server.stats_fn()
        body = json.dumps(stats).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _hollow_watcher_pool(cacher, kind: str, n_watchers: int, n_sampled: int = 64):
    """Attach n hollow watchers to this frontend's OWN cache fan-out
    (the kubemark discipline: real queues, a shared drain pool instead
    of n threads) and return a stats closure for /bench-stats."""
    import time as _time

    from ..runtime.watch import BOOKMARK

    watchers = [cacher.watch(kind) for _ in range(n_watchers)]
    sampled = watchers[: min(n_sampled, n_watchers)]
    latencies: list = []
    drained = [0]
    lock = threading.Lock()

    def drain_loop(ws):
        while True:
            idle = True
            for w in ws:
                ev = w.get(timeout=0)
                while ev is not None:
                    idle = False
                    if ev.type != BOOKMARK and ev.ts:
                        with lock:
                            latencies.append(_time.monotonic() - ev.ts)
                            drained[0] += 1
                    ev = w.get(timeout=0)
            if idle:
                _time.sleep(0.001)

    drainers = 4
    chunk = max(1, len(sampled) // drainers)
    for i in range(0, len(sampled), chunk):
        threading.Thread(
            target=drain_loop, args=(sampled[i : i + chunk],), daemon=True
        ).start()

    def stats():
        from ..utils.metrics import metrics

        with lock:
            lat = sorted(latencies)
        events = metrics.counter(
            "watch_cache_events_total", {"kind": kind}
        )
        return {
            "watchers": n_watchers,
            "sampled": len(sampled),
            "drained": drained[0],
            "cache_events": events,
            "delivery_p50_ms": lat[int(0.5 * len(lat))] * 1e3 if lat else 0.0,
            "delivery_p99_ms": (
                lat[min(int(0.99 * len(lat)), len(lat) - 1)] * 1e3
                if lat
                else 0.0
            ),
        }

    return stats


def _serve_stats(stats_fn) -> int:
    dbg = ThreadingHTTPServer(("127.0.0.1", 0), _BenchStatsHandler)
    dbg.daemon_threads = True
    dbg.stats_fn = stats_fn
    threading.Thread(target=dbg.serve_forever, daemon=True).start()
    return dbg.server_address[1]


def _relay_fleet_stats(relay, kind: str):
    """Stats closure aggregating the relay worker fleet for /bench-stats:
    client/delivery totals summed across workers, per-process CPU seconds
    kept per worker so benches can prove CPU stays flat vs watcher count."""

    def stats():
        from ..utils.metrics import metrics

        per_worker = relay.worker_stats()
        frames = metrics.counter(
            "relay_frames_published_total", {"kind": kind}
        )
        return {
            "relay_port": relay.port,
            "workers": len(per_worker),
            "frames_published": frames,
            "clients": sum(w.get("clients", 0) for w in per_worker),
            "hollow": sum(w.get("hollow", 0) for w in per_worker),
            "delivered": sum(w.get("delivered", 0) for w in per_worker),
            "evicted_slow": sum(w.get("evicted_slow", 0) for w in per_worker),
            "shed": sum(w.get("shed", 0) for w in per_worker),
            "worker_cpu_s": [w.get("cpu_s", 0.0) for w in per_worker],
            "per_worker": per_worker,
        }

    return stats


def run_frontend(
    primary: str,
    port: int,
    hollow_watchers: int,
    watch_kind: str,
    relay_workers: int = 0,
    relay_port: int = 0,
    relay_hollow: int = 0,
    tls_cert: str = "",
    tls_key: str = "",
) -> None:
    from ..apiserver.frontend import serve_frontend

    srv, bound, _client = serve_frontend(
        primary,
        port=port,
        bookmark_period_s=0.5,
        relay_workers=relay_workers,
        relay_port=relay_port,
        relay_kinds=(watch_kind,),
        relay_hollow_clients=relay_hollow,
        tls_cert=tls_cert or None,
        tls_key=tls_key or None,
    )
    stats_port = 0
    if hollow_watchers:
        stats_fn = _hollow_watcher_pool(
            srv.cacher, watch_kind, hollow_watchers
        )
        stats_port = _serve_stats(stats_fn)
    elif srv.relay is not None:
        stats_port = _serve_stats(_relay_fleet_stats(srv.relay, watch_kind))
    rport = srv.relay.port if srv.relay is not None else 0
    # trailing tokens are ignored by pre-relay READY parsers
    print(f"READY frontend {bound} {stats_port} {rport}", flush=True)
    threading.Event().wait()


def run_follower(
    primary: str,
    repl_host: str,
    repl_port: int,
    port: int,
    node_id: int,
    hollow_watchers: int,
    watch_kind: str,
) -> None:
    from ..apiserver.frontend import serve_follower_frontend
    from ..runtime.replication import Follower

    follower = Follower((repl_host, repl_port), node_id=node_id).start()
    if not follower.wait_synced(15.0):
        raise SystemExit("follower never synced")
    srv, bound, _store = serve_follower_frontend(
        follower, primary, port=port, bookmark_period_s=0.5
    )
    stats_port = 0
    if hollow_watchers:
        stats_fn = _hollow_watcher_pool(
            srv.cacher, watch_kind, hollow_watchers
        )
        stats_port = _serve_stats(stats_fn)
    print(f"READY follower {bound} {stats_port}", flush=True)
    threading.Event().wait()


# -- scheduler child ---------------------------------------------------------


class _DebugHandler(BaseHTTPRequestHandler):
    server_version = "netchaos-scheduler-debug"

    def log_message(self, *args):
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/traces"):
            # this replica's trace ring (slowest-N / by-id): the test's
            # window into which process actually minted a given id
            from urllib.parse import parse_qs, urlparse

            from ..utils.debugserver import traces_payload

            u = urlparse(self.path)
            q = {k: v[-1] for k, v in parse_qs(u.query).items()}
            code, payload = traces_payload(q)
            return self._json(code, payload)
        if self.path != "/status":
            return self._json(404, {"error": "unknown path"})
        from ..utils.metrics import metrics

        rep = self.server.replica
        fenced = sum(
            v
            for k, v in metrics.dump().items()
            if k.startswith("scheduler_ha_fenced_binds_total")
        )
        self._json(
            200,
            {
                "identity": rep.identity,
                "leader": rep.elector.is_leader,
                "promoted": rep.promoted.is_set(),
                "deposed": rep.deposed.is_set(),
                "fenced_binds": fenced,
                "pending_binds": rep.sched._ridethrough.depth,
            },
        )

    def do_POST(self):
        if self.path != "/bind":
            return self._json(404, {"error": "unknown path"})
        from ..api.objects import Binding
        from ..client.apiserver import LeaderFenced
        from ..utils.tracing import tracer

        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        binding = Binding(
            pod_name=body["name"],
            pod_namespace=body.get("namespace", "default"),
            pod_uid=body.get("uid", ""),
            target_node=body["node"],
        )
        # mint a trace for the forced bind so the cross-process trace
        # assertion holds for the FENCED path too: the ledger record the
        # store writes must carry this id
        trace_id = tracer.start(
            "pod", f"{binding.pod_namespace}/{binding.pod_name}"
        )
        # the replica's OWN fence-attaching seam: exactly the write a
        # zombie's late wave would issue — including the wave path's
        # fence handling (_on_fenced_binds drops the placement and counts
        # under the transport label)
        sched = self.server.replica.sched
        try:
            errs = sched._bind_pods_fenced([binding])
        except LeaderFenced as e:
            from ..api.objects import ObjectMeta, Pod
            from ..scheduler.queue.scheduling_queue import QueuedPodInfo

            sched._on_fenced_binds(
                [
                    QueuedPodInfo(
                        pod=Pod(
                            metadata=ObjectMeta(
                                name=binding.pod_name,
                                namespace=binding.pod_namespace,
                                uid=binding.pod_uid,
                            )
                        ),
                        trace_id=trace_id,
                    )
                ]
            )
            tracer.finish(trace_id, outcome="fenced")
            return self._json(
                200,
                {"result": "LeaderFenced", "message": str(e),
                 "trace": trace_id},
            )
        except Exception as e:
            tracer.finish(trace_id, outcome=type(e).__name__)
            return self._json(
                200,
                {"result": type(e).__name__, "message": str(e),
                 "trace": trace_id},
            )
        err = errs[0] if errs else None
        if err is None:
            tracer.finish(trace_id, outcome="bound")
            return self._json(200, {"result": "ok", "trace": trace_id})
        tracer.finish(trace_id, outcome=type(err).__name__)
        return self._json(
            200,
            {"result": type(err).__name__, "message": str(err),
             "trace": trace_id},
        )


class _Replica:
    """One scheduler replica over REST: standby first, the election
    winner promotes with the fence (the cmd/scheduler.py wiring)."""

    def __init__(self, server_url: str, identity: str, lease_cfg,
                 zombie_hold: bool, device: DeviceLike = None):
        from ..apiserver.client import RESTClient
        from ..client.leaderelection import LeaderElector
        from ..scheduler import KubeSchedulerConfiguration, Scheduler

        self.identity = identity
        self.client = RESTClient(server_url, timeout=5.0)
        cfg = KubeSchedulerConfiguration(use_device=False)
        self.sched = Scheduler(self.client, cfg, device=device)
        self.sched.start_standby(identity=identity)
        self.promoted = threading.Event()
        self.deposed = threading.Event()

        def on_started():
            self.sched.promote(fence=self.elector.fence())
            self.promoted.set()

        def on_stopped():
            self.deposed.set()
            if zombie_hold:
                # the misbehaving replica: keeps scheduling with its
                # stale fence — the store must stop it, not its manners
                logger.error(
                    "%s deposed; ZOMBIE-HOLD: scheduling loops stay up",
                    identity,
                )
                return
            logger.error("%s deposed; stopping scheduling", identity)
            self.sched.stop()

        self.elector = LeaderElector(
            self.client,
            lease_cfg,
            on_started_leading=on_started,
            on_stopped_leading=on_stopped,
        )
        self._thread = threading.Thread(
            target=self.elector.run, daemon=True, name=f"elector-{identity}"
        )
        self._thread.start()


def run_scheduler(
    server_url: str,
    identity: str,
    debug_port: int,
    lease_duration: float,
    renew_deadline: float,
    retry_period: float,
    zombie_hold: bool,
    device: DeviceLike = None,
) -> None:
    from ..client.leaderelection import LeaderElectionConfig

    # no card and no explicit device: raise before the replica starts
    device = resolve_device(device)

    lease_cfg = LeaderElectionConfig(
        identity=identity,
        lease_duration=lease_duration,
        renew_deadline=renew_deadline,
        retry_period=retry_period,
    )
    replica = _Replica(server_url, identity, lease_cfg, zombie_hold, device)
    dbg = ThreadingHTTPServer(("127.0.0.1", debug_port), _DebugHandler)
    dbg.daemon_threads = True
    dbg.replica = replica
    threading.Thread(target=dbg.serve_forever, daemon=True).start()
    print(f"READY scheduler {identity} {dbg.server_address[1]}", flush=True)
    threading.Event().wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="netchaos-procs")
    sub = parser.add_subparsers(dest="role", required=True)
    ap = sub.add_parser("apiserver")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--ledger", required=True)
    ap.add_argument("--repl-port", type=int, default=0)
    ap.add_argument("--cluster-size", type=int, default=0)
    fr = sub.add_parser("frontend")
    fr.add_argument("--primary", required=True)
    fr.add_argument("--port", type=int, default=0)
    fr.add_argument("--hollow-watchers", type=int, default=0)
    fr.add_argument("--watch-kind", default="pods")
    fr.add_argument("--relay-workers", type=int, default=0)
    fr.add_argument("--relay-port", type=int, default=0)
    fr.add_argument("--relay-hollow", type=int, default=0)
    fr.add_argument("--tls-cert", default="")
    fr.add_argument("--tls-key", default="")
    fo = sub.add_parser("follower")
    fo.add_argument("--primary", required=True)
    fo.add_argument("--repl-host", default="127.0.0.1")
    fo.add_argument("--repl-port", type=int, required=True)
    fo.add_argument("--port", type=int, default=0)
    fo.add_argument("--node-id", type=int, default=1)
    fo.add_argument("--hollow-watchers", type=int, default=0)
    fo.add_argument("--watch-kind", default="pods")
    sp = sub.add_parser("scheduler")
    sp.add_argument("--server", required=True)
    sp.add_argument("--identity", required=True)
    sp.add_argument("--debug-port", type=int, default=0)
    sp.add_argument("--lease-duration", type=float, default=1.5)
    sp.add_argument("--renew-deadline", type=float, default=1.0)
    sp.add_argument("--retry-period", type=float, default=0.2)
    sp.add_argument("--zombie-hold", action="store_true", default=False)
    sp.add_argument(
        "--platform",
        default="",
        help="'cpu' runs the replica's Scheduler on the CPU; any other "
        "value, or none, runs it on the CUDA card",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.role == "apiserver":
        run_apiserver(
            args.port, args.ledger, args.repl_port, args.cluster_size
        )
    elif args.role == "frontend":
        run_frontend(
            args.primary,
            args.port,
            args.hollow_watchers,
            args.watch_kind,
            relay_workers=args.relay_workers,
            relay_port=args.relay_port,
            relay_hollow=args.relay_hollow,
            tls_cert=args.tls_cert,
            tls_key=args.tls_key,
        )
    elif args.role == "follower":
        run_follower(
            args.primary,
            args.repl_host,
            args.repl_port,
            args.port,
            args.node_id,
            args.hollow_watchers,
            args.watch_kind,
        )
    else:
        run_scheduler(
            args.server,
            args.identity,
            args.debug_port,
            args.lease_duration,
            args.renew_deadline,
            args.retry_period,
            args.zombie_hold,
            device="cpu" if args.platform == "cpu" else None,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
