"""NodeGroup catalog: the candidate machine shapes the autoscaler may add.

Reference: the cluster-autoscaler's cloudprovider.NodeGroup contract
(TemplateNodeInfo / IncreaseSize / DeleteNodes) — a group is a homogeneous
pool of a single machine shape with [min_size, max_size] bounds. Here a
group's shape is simply a `v1.Node` template function; what-if simulation
encodes the template into virtual snapshot rows (ops/encoding.whatif_
overlay), so the SAME columnar encoding that drives live scheduling
describes candidate capacity — no parallel machine-type model to drift.

Provisioning is pluggable: by default a scale-up just creates the Node
object through the apiserver (the perf harness's store-acked world); tests
and the kubemark rig pass hooks that also start a hollow kubelet for the
new node (`kubemark.HollowCluster.provisioner_for`), so the node
heartbeats and accepts binds like any fleet member.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..api import objects as v1
from ..api.objects import LABEL_NODEGROUP


def machine_shape(
    cpu: str = "4",
    memory: str = "32Gi",
    pods: int = 110,
    labels: Optional[dict] = None,
    taints: Optional[list] = None,
    cost_per_hour: Optional[float] = None,
    accelerator_class: Optional[str] = None,
    energy_watts: Optional[float] = None,
) -> Callable[[str], v1.Node]:
    """Node template for a homogeneous machine shape (the moral equivalent
    of cloudprovider TemplateNodeInfo). cost_per_hour / accelerator_class /
    energy_watts stamp the encoder's heterogeneity-column labels
    (ops/encoding.LABEL_*), so the SAME columns drive live scoring
    policies and the autoscaler's cheapest-feasible-shape packing."""
    from ..ops.encoding import (
        LABEL_ACCELERATOR_CLASS,
        LABEL_COST_PER_HOUR,
        LABEL_ENERGY_WATTS,
    )

    shape_labels = dict(labels or {})
    if cost_per_hour is not None:
        shape_labels[LABEL_COST_PER_HOUR] = str(cost_per_hour)
    if accelerator_class is not None:
        shape_labels[LABEL_ACCELERATOR_CLASS] = accelerator_class
    if energy_watts is not None:
        shape_labels[LABEL_ENERGY_WATTS] = str(energy_watts)

    def template(name: str) -> v1.Node:
        return v1.Node(
            metadata=v1.ObjectMeta(
                name=name, namespace="", labels=dict(shape_labels)
            ),
            spec=v1.NodeSpec(taints=list(taints or [])),
            status=v1.NodeStatus(
                capacity={"cpu": cpu, "memory": memory, "pods": pods},
                allocatable={"cpu": cpu, "memory": memory, "pods": pods},
                conditions=[
                    v1.NodeCondition(type=v1.NODE_READY, status="True")
                ],
            ),
        )

    return template


@dataclass
class NodeGroup:
    """One scalable pool of a single machine shape.

    provision(name) must make the node REAL: create the Node object (and,
    on rigs with kubelets, start one for it). deprovision(name) tears the
    node's agent down after scale-down deleted the object. Both default to
    apiserver-only behavior supplied by the controller."""

    name: str
    template: Callable[[str], v1.Node]
    min_size: int = 0
    max_size: int = 1000
    provision: Optional[Callable[[str], object]] = None
    deprovision: Optional[Callable[[str], object]] = None
    _counter: itertools.count = field(
        default_factory=itertools.count, repr=False
    )

    def make_node(self, name: str) -> v1.Node:
        """Instantiate the template and stamp the group label (how
        scale-down attributes a live node back to this group)."""
        node = self.template(name)
        node.metadata.labels[LABEL_NODEGROUP] = self.name
        return node

    def cost_per_hour(self) -> float:
        """The shape's cost-per-hour from its template's heterogeneity
        label (0.0 when unlabeled) — the autoscaler_shape_cost_* metric
        source and the hetero bench's fleet-cost accounting."""
        from ..ops.encoding import LABEL_COST_PER_HOUR

        raw = self.template("__shape__").metadata.labels.get(
            LABEL_COST_PER_HOUR
        )
        try:
            return float(raw) if raw else 0.0
        except (TypeError, ValueError):
            return 0.0

    def next_name(self, taken) -> str:
        """Next collision-free node name for this group."""
        while True:
            name = f"{self.name}-{next(self._counter)}"
            if name not in taken:
                return name


class NodeGroupCatalog:
    """The ordered shape catalog a planner evaluates in one overlay pass."""

    def __init__(self, groups: List[NodeGroup]):
        if not groups:
            raise ValueError("catalog needs at least one NodeGroup")
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate NodeGroup names: {names}")
        self.groups = list(groups)

    def group(self, name: str) -> Optional[NodeGroup]:
        return next((g for g in self.groups if g.name == name), None)

    def group_of_node(self, node: v1.Node) -> Optional[NodeGroup]:
        return self.group(node.metadata.labels.get(LABEL_NODEGROUP, ""))

    def sizes(self, nodes: List[v1.Node]) -> dict:
        """Live size per group, from the nodegroup label."""
        out = {g.name: 0 for g in self.groups}
        for n in nodes:
            gname = n.metadata.labels.get(LABEL_NODEGROUP)
            if gname in out:
                out[gname] += 1
        return out
