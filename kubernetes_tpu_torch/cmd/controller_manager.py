"""kube-controller-manager process entry.

Reference: cmd/kube-controller-manager/app/controllermanager.go — runs the
reconcile loops against the API server (remote REST or in-process).
"""

from __future__ import annotations

import argparse
import logging
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-controller-manager-tpu")
    parser.add_argument(
        "--server", default="http://127.0.0.1:18080", help="API server URL"
    )
    parser.add_argument(
        "--controllers",
        default="*",
        help="comma-separated controller names, * = all",
    )
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument(
        "--debug-port",
        type=int,
        default=None,
        help="serve /metrics (Prometheus text) and /debug/traces on this "
        "loopback port (default off; 0 = ephemeral)",
    )
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    if args.debug_port is not None:
        from ..utils.debugserver import serve_debug

        serve_debug(args.debug_port)
    from ..apiserver.client import RESTClient
    from ..client.leaderelection import LeaderElectionConfig
    from ..controller.manager import ControllerManager

    client = RESTClient(args.server)
    names = None if args.controllers == "*" else args.controllers.split(",")
    le = (
        LeaderElectionConfig(lock_name="kube-controller-manager")
        if args.leader_elect
        else None
    )
    mgr = ControllerManager(client, controllers=names, leader_election=le)
    mgr.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        mgr.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
