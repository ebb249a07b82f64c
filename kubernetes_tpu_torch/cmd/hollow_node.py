"""kubemark hollow-node process entry.

Reference: cmd/kubemark/hollow-node.go — N hollow kubelets against a remote
API server (one process can host thousands; see kubemark/hollow_node.py).
"""

from __future__ import annotations

import argparse
import logging
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="hollow-node-tpu")
    parser.add_argument("--server", default="http://127.0.0.1:18080")
    parser.add_argument("--count", type=int, default=1)
    parser.add_argument("--name-prefix", default="hollow-node")
    parser.add_argument("--cpu", default="4")
    parser.add_argument("--memory", default="32Gi")
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    from ..apiserver.client import RESTClient
    from ..kubemark import HollowCluster

    client = RESTClient(args.server)
    cluster = HollowCluster(
        client, num_nodes=args.count, name_prefix=args.name_prefix
    )
    cluster.start()
    logging.getLogger("kubernetes_tpu.cmd.hollow_node").info(
        "registered %d hollow nodes", args.count
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        cluster.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
