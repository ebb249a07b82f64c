"""kube-scheduler process entry (port).

PyTorch port of ``kubernetes_tpu/cmd/scheduler.py``: the same health and
metrics endpoints, watch cache, debug server, SIGUSR2 cache debugger,
shared eviction budget, autoscaler, descheduler and policy gym (each
following leadership) and warm standby under leader election. What
changed:

* ``run(..., device=None)`` hands ``device`` to the ``Scheduler``: None is
  the CUDA card (raises without one), ``"cpu"`` runs on the CPU.
* ``--platform cpu`` means ``device="cpu"``; any other value, or none,
  means the card. The reference forces a JAX platform instead.
* The reference enables XLA's persistent compilation cache at start
  (``utils/compilation_cache.py``). That cache exists only for XLA and
  has no port: eager torch compiles nothing, and the hand-written kernels
  are built once per source hash into ``build/kernels/``.

The reference's notes follow.

Reference: cmd/kube-scheduler/app/server.go — runCommand/Setup (:302),
Run (:142): healthz server (:10251, server.go:160-171), metrics mux
(:237-268 with the debug DELETE reset), leader election gating sched.Run
(:196-210 — losing leadership is fatal), SIGUSR2 cache debugger.

The API backend is the in-process store by default; ``--server URL``
runs the replica against a remote apiserver process over REST (leases,
informer streams, and leadership-fenced binds all cross the wire — the
/binding route validates the X-Leadership-Fence header).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..client.apiserver import APIServer
from ..client.leaderelection import LeaderElectionConfig, LeaderElector
from ..device import DeviceLike, resolve_device
from ..scheduler import KubeSchedulerConfiguration, Scheduler
from ..scheduler.apis_config import load_config_file
from ..scheduler.cache.debugger import CacheDebugger
from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu_torch.cmd.scheduler")


class _HealthHandler(BaseHTTPRequestHandler):
    server_version = "kube-scheduler-tpu"

    def log_message(self, *args):
        pass

    def _respond(self, code: int, body: bytes, ctype="text/plain"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/healthz", "/livez"):
            # liveness: the process is serving — a WARM STANDBY is alive
            # (reference kube-scheduler serves healthz OK while waiting
            # for the lease; a liveness probe must not restart-loop every
            # standby replica out of its warm state)
            ok = self.server.health_check()
            self._respond(200 if ok else 500, b"ok" if ok else b"unhealthy")
        elif self.path == "/readyz":
            # readiness: actually leading (scheduling loops running)
            ok = self.server.ready_check()
            self._respond(200 if ok else 500, b"ok" if ok else b"standby")
        elif self.path == "/metrics":
            # content negotiation: Prometheus exposition text by default
            # (what the reference's legacyregistry serves); JSON on request
            from ..utils.debugserver import metrics_payload

            if "application/json" in (self.headers.get("Accept") or ""):
                from ..utils.tracing import tracer

                tracer.publish_gauges()  # tracing series are batch-published
                body = json.dumps(metrics.dump(), indent=1).encode()
                self._respond(200, body, "application/json")
            else:
                self._respond(200, *metrics_payload())
        else:
            self._respond(404, b"not found")

    def do_DELETE(self):
        # debug handler: DELETE /metrics resets (server.go:237-247)
        if self.path == "/metrics":
            metrics.reset()
            self._respond(200, b"metrics reset\n")
        else:
            self._respond(404, b"not found")


def serve_health(port: int, health_check, ready_check=None) -> ThreadingHTTPServer:
    srv = ThreadingHTTPServer(("0.0.0.0", port), _HealthHandler)
    srv.health_check = health_check
    srv.ready_check = ready_check or health_check
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def run(
    server: Optional[APIServer] = None,
    config: Optional[KubeSchedulerConfiguration] = None,
    healthz_port: int = 10251,
    block: bool = True,
    autoscaler_catalog=None,
    autoscaler_kwargs: Optional[dict] = None,
    watch_cache: bool = True,
    debug_port: Optional[int] = None,
    deschedule: bool = False,
    descheduler_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
) -> Scheduler:
    """app.Run (server.go:142): health endpoints → informers → leader
    election (optional) → scheduling loops. autoscaler_catalog (a
    NodeGroupCatalog) additionally runs the kernel-driven cluster
    autoscaler against this scheduler's snapshot — it follows the
    scheduler's leadership (starts with scheduling, stops with it).

    watch_cache: point the scheduler's informers at a shared Cacher
    (apiserver/cacher.py) instead of direct store watches — N scheduler
    replicas (leader + warm standbys) then cost ONE store watch per kind
    total; writes pass through to the store untouched.

    With leader election configured the process starts as a WARM STANDBY
    (informers tailing, HBM snapshot + kernels warm, nothing scheduling)
    and the election winner promotes: it adopts the dead leader's
    in-flight wave from store read-back and arms the leadership bind
    fence so a zombie ex-leader's late binds are rejected.

    device: where the Scheduler's snapshot and kernels live (None: the
    CUDA card, raising without one; "cpu" runs on the CPU)."""
    # no card and no explicit device: raise before anything starts
    device = resolve_device(device)
    server = server or APIServer()
    cfg = config or KubeSchedulerConfiguration()
    backend = server
    if watch_cache:
        from ..apiserver.cacher import Cacher

        backend = Cacher(server)
    sched = Scheduler(backend, cfg, device=device)
    if backend is not server:
        sched._owned_read_cache = backend  # torn down by sched.stop()
    # live = the process is serving (a warm standby IS live); ready =
    # actually leading. Split so a liveness probe never restart-loops a
    # standby replica out of its warm state.
    live = threading.Event()
    ready = threading.Event()
    if healthz_port:
        serve_health(
            healthz_port, lambda: live.is_set(), lambda: ready.is_set()
        )
    if debug_port is not None:
        # /metrics + /debug/traces for THIS scheduler process (the
        # SIGUSR2 dump's HTTP twin — trace lookups without log access)
        from ..utils.debugserver import serve_debug

        serve_debug(debug_port)
    CacheDebugger(sched).listen_for_signal()

    stop = threading.Event()
    # ONE process-wide eviction token bucket: nodelifecycle drains,
    # autoscaler scale-down, preemption victim deletes, and descheduler
    # consolidation all draw from the same qps+burst — three storms can't
    # triple the eviction rate (controller/evictionbudget.py)
    from ..controller.evictionbudget import EvictionBudget

    a_kwargs = dict(autoscaler_kwargs or {})
    budget = a_kwargs.get("eviction_budget") or EvictionBudget(
        a_kwargs.get("eviction_qps", 10.0),
        a_kwargs.get("eviction_burst", 5),
    )
    a_kwargs["eviction_budget"] = budget
    sched.eviction_budget = budget
    autoscaler = None
    if autoscaler_catalog is not None:
        from ..autoscaler import ClusterAutoscaler

        autoscaler = ClusterAutoscaler(
            server, sched, autoscaler_catalog, **a_kwargs
        )
        sched._autoscaler = autoscaler
    descheduler = None
    if deschedule:
        # the descheduler follows scheduler leadership exactly like the
        # autoscaler, shares its eviction budget, and talks to the RAW
        # store (evictions and cordons are fenced writes, never cached)
        from ..descheduler import Descheduler

        descheduler = Descheduler(
            server,
            sched,
            budget,
            catalog=autoscaler_catalog,
            **(descheduler_kwargs or {}),
        )
        sched._descheduler = descheduler
    tuner = None
    if cfg.tune_policy:
        # the policy gym follows leadership like the autoscaler: only the
        # leader records waves, replays candidates, and promotes. It
        # talks to the RAW store (never the cacher) — the persisted
        # ScorePolicy object is the failover-adoption authority
        from ..tuner.controller import PolicyTuner

        tuner = PolicyTuner(sched, server)
        sched._tuner = tuner

    def start_scheduling():
        sched.start()
        if autoscaler is not None:
            autoscaler.start()
        if descheduler is not None:
            descheduler.start()
        if tuner is not None:
            tuner.start()
        live.set()
        ready.set()

    elector = None
    elector_thread = None
    if cfg.leader_election is not None:
        # warm standby FIRST: by the time the election resolves (instant
        # for the first replica, a failover later for the rest) the cache,
        # the HBM snapshot, and the compiled kernels are already hot
        sched.start_standby(identity=cfg.leader_election.identity)
        live.set()  # a warm standby is live (not yet ready)

        def on_started():
            sched.promote(fence=elector.fence())
            if autoscaler is not None:
                autoscaler.start()
            if descheduler is not None:
                descheduler.start()
            if tuner is not None:
                tuner.start()
            ready.set()

        def on_stopped():
            # leaderelection.go: losing the lease is fatal for the process
            logger.error("leader election lost; shutting down scheduling")
            ready.clear()
            live.clear()
            if tuner is not None:
                tuner.stop()
            if descheduler is not None:
                descheduler.stop()
            if autoscaler is not None:
                autoscaler.stop()
            sched.stop()
            stop.set()

        # the elector talks to the raw store: lease reads/writes are the
        # fencing authority and must never be served from a cache
        elector = LeaderElector(
            server,
            cfg.leader_election,
            on_started_leading=on_started,
            on_stopped_leading=on_stopped,
        )
        elector_thread = threading.Thread(target=elector.run, daemon=True)
        elector_thread.start()
        sched._elector = elector
        sched._elector_thread = elector_thread
    else:
        start_scheduling()

    if block:
        try:
            while not stop.is_set():
                stop.wait(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            if elector is not None:
                # graceful shutdown RELEASES the lease (ReleaseOnCancel):
                # the standby promotes in retry-periods, not after waiting
                # out lease_duration — join so the release lands before
                # the process exits
                elector.stop()
                if elector_thread is not None:
                    elector_thread.join(timeout=5.0)
            if tuner is not None:
                tuner.stop()
            if descheduler is not None:
                descheduler.stop()
            if autoscaler is not None:
                autoscaler.stop()
            sched.stop()
    return sched


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-scheduler-tpu")
    parser.add_argument("--config", help="ComponentConfig or Policy file")
    parser.add_argument("--healthz-port", type=int, default=10251)
    parser.add_argument(
        "--debug-port",
        type=int,
        default=None,
        help="serve /metrics (Prometheus text) and /debug/traces "
        "(slowest-N / by-trace-id lookup) on this loopback port "
        "(default off; 0 = ephemeral)",
    )
    parser.add_argument(
        "--leader-elect", action="store_true", default=False
    )
    parser.add_argument(
        "--leader-elect-identity",
        default="",
        help="lease holder identity for this replica (default "
        "hostname_uuid); replicas past the first start as warm standbys",
    )
    parser.add_argument(
        "--no-watch-cache",
        action="store_true",
        default=False,
        help="informers watch the store directly instead of the shared "
        "watch cache (one store watch per kind per replica)",
    )
    parser.add_argument(
        "--server",
        default="",
        help="API server base URL (e.g. http://127.0.0.1:18080): run this "
        "replica against a remote apiserver process over REST instead of "
        "an in-process store. Leader election and bind fencing work "
        "end-to-end over the wire (the /binding route validates the "
        "X-Leadership-Fence header)",
    )
    parser.add_argument(
        "--platform",
        default="",
        help="'cpu' runs the scheduler's device path on the CPU; any "
        "other value, or none, runs it on the CUDA card",
    )
    parser.add_argument(
        "--autoscale-shapes",
        default="",
        help="enable the kernel-driven cluster autoscaler with a shape "
        "catalog: semicolon-separated 'name:cpu,memory,maxPods,maxSize' "
        "entries (e.g. 'small:4,32Gi,110,100;big:32,256Gi,110,20')",
    )
    parser.add_argument(
        "--deschedule",
        action="store_true",
        default=False,
        help="run the verified descheduler: consolidation plans proven on "
        "the what-if overlay before any eviction, executed in budgeted "
        "waves with drift re-simulation, PDB re-checks, gang quorum, and "
        "uncordon rollback (shares the process-wide eviction budget)",
    )
    parser.add_argument(
        "--score-policy",
        default="",
        help="named score policy (ops/lattice.WEIGHT_PROFILES: 'default', "
        "'pack', 'cheapest', 'energy', ...): a runtime weight VECTOR over "
        "the score components — swapping policies never recompiles the "
        "kernels (Scheduler.set_score_policy swaps live)",
    )
    parser.add_argument(
        "--tune-policy",
        action="store_true",
        default=False,
        help="run the policy gym (tuner/): record real scheduling waves, "
        "replay candidate weight vectors against them in the background, "
        "and promote winners through a shadow A/B gate — the promoted "
        "vector persists as the ScorePolicy API object so failover adopts "
        "it instead of reverting to the default",
    )
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    device = "cpu" if args.platform == "cpu" else None
    cfg = (
        load_config_file(args.config)
        if args.config
        else KubeSchedulerConfiguration()
    )
    if args.leader_elect and cfg.leader_election is None:
        cfg.leader_election = LeaderElectionConfig()
    if args.leader_elect_identity and cfg.leader_election is not None:
        cfg.leader_election.identity = args.leader_elect_identity
    if args.score_policy:
        cfg.score_policy = args.score_policy
        cfg.validate()  # unknown names fail here, not mid-wave
    if args.tune_policy:
        cfg.tune_policy = True
    catalog = None
    if args.autoscale_shapes:
        from ..autoscaler import NodeGroup, NodeGroupCatalog, machine_shape

        groups = []
        for entry in filter(None, args.autoscale_shapes.split(";")):
            name, spec = entry.split(":", 1)
            cpu, memory, max_pods, max_size = spec.split(",")
            groups.append(
                NodeGroup(
                    name=name.strip(),
                    template=machine_shape(
                        cpu=cpu.strip(),
                        memory=memory.strip(),
                        pods=int(max_pods),
                    ),
                    max_size=int(max_size),
                )
            )
        catalog = NodeGroupCatalog(groups)
    server = None
    if args.server:
        from ..apiserver.client import RESTClient

        server = RESTClient(args.server)
    run(
        server=server,
        config=cfg,
        healthz_port=args.healthz_port,
        autoscaler_catalog=catalog,
        watch_cache=not args.no_watch_cache,
        debug_port=args.debug_port,
        deschedule=args.deschedule,
        device=device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
