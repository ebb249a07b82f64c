"""Consolidation planning: evict-sets proven safe on the what-if overlay.

Reference shape: the descheduler project's LowNodeUtilization +
HighNodeUtilization strategies (sigs.k8s.io/descheduler) pick victims by
re-implementing scheduler predicates host-side. Here — exactly like the
autoscaler's scale-down (autoscaler/planner.py) — the feasibility proof
IS the production lattice kernel: candidate under-utilized/expensive
nodes have their rows masked out of a `whatif_overlay` copy of the live
snapshot, every resident pod's RECREATION is replayed through
`make_schedule_batch`, and a plan is accepted only when everything
re-binds with the evict-set gone (`simulate_drain_set`, the same verdict
the autoscaler trusts for single-node drains).

A plan is rejected at SIMULATION time (never discovered mid-eviction)
when:

  * pods are pending — freed capacity belongs to the backlog, and
    evicting residents to then seat lower-priority queue pods would
    invert the priority bands (the caller gates on this);
  * any resident is unmovable (no controller to recreate it, no
    safe-to-evict annotation) or sits above the victim priority ceiling
    (system bands are never consolidation victims);
  * evicting the set would drop any gang below its min-member quorum
    (coscheduling plugin's group label/annotation — the gang-strand
    rejection);
  * the kernel cannot re-place every resident strictly within the
    remaining fleet (zero newly-pending pods).

Accepted plans are strictly tighter/cheaper by construction: the node
count drops by len(evict-set) and the fleet bill drops by the set's
summed `cost_milli`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import objects as v1
from ..api.objects import ANN_SAFE_TO_EVICT
from ..autoscaler.planner import WhatIfSimulator, simulate_drain_set
from ..scheduler.framework.plugins.coscheduling import gang_key, min_member
from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.descheduler.planner")

COUNTER_PLAN_REJECTED = "descheduler_plan_rejected_total"


@dataclass
class ConsolidationPlan:
    """One accepted evict-set with everything the executor re-verifies."""

    nodes: List[str]  # evict-set, execution order
    victims: Dict[str, List[str]]  # node -> non-DaemonSet pod keys at plan time
    node_cost_milli: Dict[str, int]  # node -> cost_milli ($/h * 1000)
    replaced: int  # resident pods the simulation re-placed
    generation: int  # encoder generation the plan was proven against

    @property
    def cost_drop_milli(self) -> int:
        return sum(self.node_cost_milli.values())

    @property
    def victim_count(self) -> int:
        return sum(len(v) for v in self.victims.values())


def movable(pod: v1.Pod) -> bool:
    """Same contract as the autoscaler's scale-down: a pod may be evicted
    only if a controller will recreate it (owner references — DaemonSet
    owners included: those pods are excluded from simulation AND eviction
    separately, they die with the node) or it is annotated
    safe-to-evict."""
    if pod.metadata.owner_references:
        return True
    return (
        pod.metadata.annotations.get(ANN_SAFE_TO_EVICT, "").lower() == "true"
    )


def is_daemonset_pod(pod: v1.Pod) -> bool:
    return any(r.kind == "DaemonSet" for r in pod.metadata.owner_references)


def gang_census(node_infos) -> Dict[str, Tuple[int, int]]:
    """gang key -> (live bound members, quorum) over the whole fleet.
    Quorum is the max min-member annotation seen across members (a gang
    whose members disagree gets the conservative bound)."""
    out: Dict[str, Tuple[int, int]] = {}
    for ni in node_infos.values():
        for pod in ni.pods:
            key = gang_key(pod)
            if key is None:
                continue
            live, quorum = out.get(key, (0, 1))
            out[key] = (live + 1, max(quorum, min_member(pod)))
    return out


def gang_strands(
    evict_victims: Dict[str, List[v1.Pod]],
    census: Dict[str, Tuple[int, int]],
) -> List[str]:
    """Gang keys the evict-set would drop below quorum. Evicted members
    ARE recreated by their controllers, but between the eviction wave and
    the re-bind the gang runs below min-member — a plan that transits
    that state is rejected outright (the gang-strand rejection)."""
    planned: Dict[str, int] = {}
    for pods in evict_victims.values():
        for pod in pods:
            key = gang_key(pod)
            if key is not None:
                planned[key] = planned.get(key, 0) + 1
    return [
        key
        for key, k in planned.items()
        if census.get(key, (0, 1))[0] - k < census.get(key, (0, 1))[1]
    ]


@dataclass
class _Candidate:
    name: str
    row: int
    util: float
    cost_milli: int
    residents: List[v1.Pod] = field(default_factory=list)  # all, incl. DS
    victims: List[v1.Pod] = field(default_factory=list)  # non-DS


def plan_consolidation(
    sim: WhatIfSimulator,
    cache,
    util_threshold: float = 0.5,
    max_nodes_per_plan: int = 2,
    max_victim_priority: int = 1_000_000_000,
) -> Tuple[Optional[ConsolidationPlan], str]:
    """One planning pass. Returns (plan, "") on acceptance or
    (None, reason) — reasons land in descheduler_plan_rejected_total.

    Candidates are live, uncordoned, non-empty nodes at or under
    ``util_threshold``, ordered cheapest-to-liberate first (utilization
    asc, then cost desc — an expensive near-empty node is the best
    eviction money can buy). The evict-set grows greedily under the gang
    quorum constraint, then the WHOLE set is proven by one masked-rows
    kernel pass; an infeasible multi-node set falls back to proving its
    first node alone before giving up."""
    enc = cache.encoder
    with cache.lock:
        stats = enc.utilization_stats()
        row_names = list(enc.row_names)
        generation = enc.generation
    infos = cache.node_infos()

    candidates: List[_Candidate] = []
    for row, name in enumerate(row_names):
        if name is None or not stats.valid[row]:
            continue
        if stats.unschedulable[row] or not stats.used_any[row]:
            # cordoned nodes are someone's drain already; EMPTY nodes need
            # no eviction — deleting those is the autoscaler's scale-down
            continue
        if stats.util[row] > util_threshold:
            continue
        ni = infos.get(name)
        if ni is None or ni.node is None or ni.node.spec.unschedulable:
            continue
        cand = _Candidate(
            name=name,
            row=row,
            util=float(stats.util[row]),
            cost_milli=int(stats.cost_milli[row]),
            residents=list(ni.pods),
        )
        blocked = ""
        for pod in cand.residents:
            if is_daemonset_pod(pod):
                continue
            if not movable(pod):
                blocked = "unmovable_pods"
                break
            if (pod.priority or 0) > max_victim_priority:
                # system bands are never consolidation victims — and with
                # the pending-backlog gate this is the "never evict
                # higher-priority to seat lower" guard's second half
                blocked = "priority_band"
                break
            cand.victims.append(pod)
        if blocked:
            metrics.inc(COUNTER_PLAN_REJECTED, {"reason": blocked})
            continue
        candidates.append(cand)
    if not candidates:
        metrics.inc(COUNTER_PLAN_REJECTED, {"reason": "no_candidates"})
        return None, "no_candidates"

    # cheapest-to-liberate first: utilization asc, cost desc, stable name
    candidates.sort(key=lambda c: (c.util, -c.cost_milli, c.name))

    census = gang_census(infos)
    chosen: List[_Candidate] = []
    for cand in candidates:
        if len(chosen) >= max_nodes_per_plan:
            break
        tentative = {c.name: c.victims for c in chosen + [cand]}
        stranded = gang_strands(tentative, census)
        if stranded:
            metrics.inc(COUNTER_PLAN_REJECTED, {"reason": "gang_strand"})
            logger.info(
                "consolidation of %s rejected at simulation time: would "
                "strand gang(s) %s below min-member", cand.name, stranded,
            )
            continue
        chosen.append(cand)
    if not chosen:
        # per-candidate gang_strand increments already happened above
        return None, "gang_strand"

    attempts = [chosen] if len(chosen) == 1 else [chosen, chosen[:1]]
    for attempt in attempts:
        names = [c.name for c in attempt]
        residents = [p for c in attempt for p in c.residents]
        verdict = simulate_drain_set(sim, names, residents, kind="defrag")
        if verdict.ok:
            plan = ConsolidationPlan(
                nodes=names,
                victims={
                    c.name: [p.metadata.key for p in c.victims]
                    for c in attempt
                },
                node_cost_milli={c.name: c.cost_milli for c in attempt},
                replaced=verdict.replaced,
                generation=generation,
            )
            logger.info(
                "consolidation plan accepted: drain %s (%d pods re-place "
                "in simulation, fleet bill drops %d milli$/h)",
                names, plan.victim_count, plan.cost_drop_milli,
            )
            return plan, ""
        logger.info(
            "consolidation of %s infeasible: %s", names, verdict.reason
        )
    metrics.inc(COUNTER_PLAN_REJECTED, {"reason": "infeasible"})
    return None, "infeasible"
