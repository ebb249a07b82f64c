"""Descheduler: verified consolidation on the what-if overlay.

The first subsystem that deliberately destroys healthy work, so every
eviction is proven safe before (plan simulation through the production
lattice kernel), during (shared eviction budget, PDB re-checks, gang
quorum, leadership fence, degraded-store pause), and after (drift
re-simulation between waves with counted uncordon rollback) it happens.
See controller.py for the loop, planner.py for plan construction, and
executor.py for the wave machinery.
"""

from .controller import Descheduler, descheduler_health_lines
from .executor import PlanExecutor
from .planner import ConsolidationPlan, plan_consolidation

__all__ = [
    "ConsolidationPlan",
    "Descheduler",
    "PlanExecutor",
    "descheduler_health_lines",
    "plan_consolidation",
]
