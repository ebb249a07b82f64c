"""kube-apiserver process entry: the REST façade as a standalone process
(port).

PyTorch port of ``kubernetes_tpu/cmd/apiserver.py``. What changed: the
reference points JAX at its persistent compilation cache at start
(``utils/compilation_cache.py``). That cache exists only for XLA and has
no port, so the call and its comment are gone; the rest of ``main`` is
the reference's line for line (``tests/test_torch_copies.py``).

Reference: cmd/kube-apiserver/app/server.go — one process serving the core
group, CRD-defined groups (apiextensions path), and aggregated groups
(APIService proxying), with optional authn/authz via apiserver/auth.py.
"""

from __future__ import annotations

import argparse
import logging
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-apiserver-tpu")
    parser.add_argument("--port", type=int, default=18080)
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    # the watch cache (apiserver/cacher.py): --watch-cache=0 falls back
    # to per-client store watches; --watch-cache-window sizes the
    # RV replay ring; --bookmark-period the progress-notify cadence
    parser.add_argument("--watch-cache", type=int, default=1)
    parser.add_argument("--watch-cache-window", type=int, default=0)
    parser.add_argument("--bookmark-period", type=float, default=2.0)
    # serving-tier scale-out (apiserver/frontend.py): --frontend-of runs
    # this process as a STATELESS frontend over a remote primary (own
    # watch cache, writes delegated upstream); --follower-of tails a
    # primary's replication listener and serves commit-gated follower
    # reads (requires --primary for the write/point-get delegate);
    # --repl-port/--cluster-size arm the primary's replication listener
    # so followers/frontend fleets have something to attach to.
    parser.add_argument("--frontend-of", default="")
    parser.add_argument("--follower-of", default="",
                        help="primary replication address host:port")
    parser.add_argument("--primary", default="",
                        help="primary REST url (follower mode)")
    parser.add_argument("--node-id", type=int, default=1)
    parser.add_argument("--repl-port", type=int, default=0)
    parser.add_argument("--cluster-size", type=int, default=0)
    # TLS on the serving hop: both given -> the REST port (and the relay
    # workers, in frontend mode) serve https
    parser.add_argument("--tls-cert", default="")
    parser.add_argument("--tls-key", default="")
    # watch-relay tier (frontend mode only, kubernetes_tpu/relay/):
    # --relay-workers N spawns N SO_REUSEPORT fan-out workers over a
    # shared-memory frame ring fed by this frontend's watch cache
    parser.add_argument("--relay-workers", type=int, default=0)
    parser.add_argument("--relay-port", type=int, default=0)
    args = parser.parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        parser.error("--tls-cert and --tls-key must be given together")
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    log = logging.getLogger("kubernetes_tpu.cmd.apiserver")
    serve_kwargs = dict(
        port=args.port,
        watch_cache=bool(args.watch_cache),
        watch_cache_window=args.watch_cache_window,
        bookmark_period_s=args.bookmark_period,
        tls_cert=args.tls_cert or None,
        tls_key=args.tls_key or None,
    )
    if args.frontend_of:
        from ..apiserver.frontend import serve_frontend

        srv, port, _client = serve_frontend(
            args.frontend_of,
            relay_workers=args.relay_workers,
            relay_port=args.relay_port,
            **serve_kwargs,
        )
        if getattr(srv, "relay", None) is not None:
            log.info(
                "watch relay on :%d (%d workers%s)",
                srv.relay.port, args.relay_workers,
                ", tls" if srv.relay.tls else "",
            )
        log.info(
            "serving /api/v1 on :%d (stateless frontend of %s)",
            port, args.frontend_of,
        )
    elif args.follower_of:
        if not args.primary:
            # no derivable fallback exists: --follower-of names the
            # REPLICATION listener, whose port says nothing about the
            # primary's REST port
            parser.error("--follower-of requires --primary (the primary's "
                         "REST url for the write/point-get delegate)")
        host, _, rport = args.follower_of.partition(":")
        from ..apiserver.frontend import serve_follower_frontend
        from ..runtime.replication import Follower

        follower = Follower((host, int(rport)), node_id=args.node_id).start()
        if not follower.wait_synced(30.0):
            log.error("follower never synced to %s", args.follower_of)
            return 1
        srv, port, _store = serve_follower_frontend(
            follower, args.primary, **serve_kwargs,
        )
        log.info(
            "serving /api/v1 on :%d (follower reads of %s)",
            port, args.follower_of,
        )
    else:
        from ..apiserver.rest import serve

        srv, port, store = serve(**serve_kwargs)
        if args.repl_port or args.cluster_size:
            from ..runtime.replication import ReplicationListener

            listener = ReplicationListener(
                port=args.repl_port,
                cluster_size=args.cluster_size or None,
            )
            listener.attach(store)
            log.info("replication listener on :%d", listener.address[1])
        log.info("serving /api/v1 on :%d", port)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
