from .kubelet import Kubelet, NodeAgentPool, make_node_object, NODE_LEASE_NS
from .runtime import ANN_FAIL, ANN_RUN_SECONDS, FakeRuntime, PodRuntime

__all__ = [
    "Kubelet",
    "NodeAgentPool",
    "make_node_object",
    "NODE_LEASE_NS",
    "FakeRuntime",
    "PodRuntime",
    "ANN_FAIL",
    "ANN_RUN_SECONDS",
]
