"""Kernel-driven cluster autoscaler.

Scale-up and scale-down decisions are batched what-if evaluations of the
PRODUCTION lattice kernel against a copy-on-append overlay of the HBM
snapshot (virtual candidate rows / masked drain rows) — no re-implemented
plugin logic, no second constraint model to drift. See planner.py for the
simulation machinery and controller.py for the loop.
"""

from .controller import ClusterAutoscaler, autoscaler_health_lines
from .nodegroups import NodeGroup, NodeGroupCatalog, machine_shape
from .planner import (
    ScaleUpPlan,
    WhatIfSimulator,
    pack_weights,
    plan_scale_up,
    simulate_drain,
)

__all__ = [
    "ClusterAutoscaler",
    "NodeGroup",
    "NodeGroupCatalog",
    "ScaleUpPlan",
    "WhatIfSimulator",
    "autoscaler_health_lines",
    "machine_shape",
    "pack_weights",
    "plan_scale_up",
    "simulate_drain",
]
