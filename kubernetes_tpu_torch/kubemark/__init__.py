"""kubemark: hollow nodes for control-plane scale testing.

Reference: pkg/kubemark (hollow_kubelet.go:95,111-118 — a real kubelet
against fake runtime/mounter) + cmd/kubemark/hollow-node.go. Hollow nodes
register as real Nodes, heartbeat status + lease, and acknowledge bound
pods as Running without running anything — how a 5000-node control plane is
exercised on one machine.
"""

from .hollow_node import HollowCluster, HollowNode  # noqa: F401
