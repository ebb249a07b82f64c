"""cloud-controller-manager process entry.

Reference: cmd/cloud-controller-manager/controller-manager.go — the cloud
loops (service LB, routes, cloud-node init, cloud-node lifecycle) run as
their OWN binary against the API server, decoupled from
kube-controller-manager so cloud-provider code stays out of the core
(the out-of-tree cloud provider split). The provider here is the fake
in-memory cloud; a real provider implements the same four-method
surfaces (LoadBalancer / Routes / Instances).
"""

from __future__ import annotations

import argparse
import logging
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cloud-controller-manager-tpu")
    parser.add_argument(
        "--server", default="http://127.0.0.1:18080", help="API server URL"
    )
    parser.add_argument(
        "--node-monitor-period", type=float, default=5.0,
        help="instance-existence sweep period (seconds)",
    )
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 4 else logging.INFO
    )
    from ..apiserver.client import RESTClient
    from ..controller.cloud import (
        CloudNodeController,
        CloudNodeLifecycleController,
        FakeCloudProvider,
        RouteController,
        ServiceLBController,
    )

    client = RESTClient(args.server)
    cloud = FakeCloudProvider()
    ctrls = [
        ServiceLBController(client, cloud=cloud),
        RouteController(client, cloud=cloud),
        CloudNodeController(client, cloud=cloud),
        CloudNodeLifecycleController(
            client, cloud=cloud, period_s=args.node_monitor_period
        ),
    ]
    for c in ctrls:
        c.start()
    logging.info("cloud-controller-manager running against %s", args.server)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        for c in ctrls:
            c.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
