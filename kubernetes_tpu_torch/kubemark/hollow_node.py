"""Hollow nodes: the kubemark scale rig, built on the real kubelet.

Reference: pkg/kubemark/hollow_kubelet.go — a REAL kubelet wired to a fake
container runtime/mounter so a 5k-node control plane runs on a few
machines. Round 1 shipped a separate hollow implementation; this now
delegates to kubelet.NodeAgentPool so hollow and real nodes share one sync
code path (kubelet/kubelet.py), differing only in the PodRuntime injected
(kubelet/runtime.py FakeRuntime).

HollowCluster keeps its original surface (add_node / start / stop /
kill_node) for the perf harness and tests.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..api import objects as v1
from ..kubelet.kubelet import (
    NODE_LEASE_NS,  # noqa: F401 — re-exported for nodelifecycle
    NodeAgentPool,
    make_node_object,
)

_ip_lock = threading.Lock()
_ip_by_seed: Dict[str, str] = {}


def _fake_pod_ip(seed: str) -> str:
    """Deterministic, collision-free fake IP per seed (uid/node name): a
    process-wide counter mapped into 10.0.0.0/8 — collision-free up to ~16M
    allocations, stable for the process lifetime (unlike hash(), which is
    PYTHONHASHSEED-randomized and birthday-collides at kubemark scale)."""
    with _ip_lock:
        ip = _ip_by_seed.get(seed)
        if ip is None:
            n = len(_ip_by_seed)
            ip = f"10.{(n // (254 * 256)) % 256}.{(n // 254) % 256}.{n % 254 + 1}"
            _ip_by_seed[seed] = ip
        return ip


def make_hollow_node(
    name: str,
    cpu: str = "4",
    memory: str = "32Gi",
    pods: int = 110,
    labels: Optional[dict] = None,
) -> v1.Node:
    return make_node_object(name, cpu=cpu, memory=memory, pods=pods, labels=labels)


class HollowNode:
    """Back-compat handle for one hollow node."""

    def __init__(self, node: v1.Node):
        self.node = node
        self.name = node.metadata.name


class HollowCluster(NodeAgentPool):
    def __init__(
        self,
        server,
        num_nodes: int = 0,
        name_prefix: str = "hollow-node",
        heartbeat_interval: float = 10.0,
        housekeeping_interval: float = 0.5,  # NodeAgentPool's default
        node_template=make_hollow_node,
    ):
        super().__init__(
            server,
            heartbeat_interval=heartbeat_interval,
            housekeeping_interval=housekeeping_interval,
        )
        self.nodes: Dict[str, HollowNode] = {}
        self._template = node_template
        for i in range(num_nodes):
            self.add_node(f"{name_prefix}-{i}")

    def add_node(self, name: str, template=None, **kw) -> HollowNode:
        node = (template or self._template)(name, **kw)
        self.server.create("nodes", node)
        try:
            from ..client.leaderelection import Lease
            import time

            self.server.create(
                "leases",
                Lease(
                    metadata=v1.ObjectMeta(name=name, namespace=NODE_LEASE_NS),
                    holder_identity=name,
                    lease_duration_seconds=40.0,
                    renew_time=time.time(),
                ),
            )
        except Exception:
            pass
        super().add_node(name, register=False)
        hn = HollowNode(node)
        self.nodes[name] = hn
        return hn

    def kill_node(self, name: str) -> None:
        """Stop heartbeating a node (the node 'dies'); nodelifecycle should
        detect and evict."""
        self.nodes.pop(name, None)
        self.remove_node(name)

    def provisioner_for(self, node_template):
        """(provision, deprovision) hooks for an autoscaler NodeGroup: a
        scale-up creates the Node object AND starts a hollow kubelet for
        it (heartbeats, leases, pod sync — a full fleet member), and a
        scale-down tears the kubelet back down after the node object is
        deleted. node_template: name -> v1.Node (the group's
        `make_node`, so the nodegroup label rides along)."""

        def provision(name: str):
            return self.add_node(name, template=node_template)

        def deprovision(name: str):
            self.kill_node(name)

        return provision, deprovision
