"""Plan execution: budgeted eviction waves with between-wave re-proof.

The executor never trusts a plan longer than one wave. Every tick
re-derives the world (leadership lease, current residents, gang census,
PDB budgets, a fresh masked-rows simulation) and compares it to what the
plan was proven against; ANY divergence discards the remainder and rolls
the cordons back — a plan is either executing against a state the kernel
just re-proved, or it is dead. Nothing is ever half-executed silently:

  * **fenced** — the leadership lease moved. A zombie descheduler writes
    NOTHING, not even the rollback uncordons (the new leader's orphan
    sweep owns those — our cordon annotation is the durable handoff).
  * **drift** — a plan node vanished, an unvetted/unmovable pod landed,
    or the re-simulation of the REMAINING evict-set stopped passing
    (e.g. a bind burst consumed the headroom the plan counted on).
    Remainder discarded, cordons rolled back, zero evictions after the
    divergence was observed.
  * **gang_change** — a fresh fleet census shows the remaining evict-set
    would now drop a gang below min-member quorum.
  * **PDB wave pause** — the pdb_blocked column is recomputed from the
    disruption controller's CURRENT budgets before every wave and any
    exhausted covering budget pauses the wave (plan stays latched; the
    store-side eviction gate stays authoritative underneath).
  * **degraded pause** — a read-only store pauses the wave mid-flight
    (counted skip); the plan stays latched and resumes when writes
    reopen, exactly the autoscaler's drain discipline.

Evictions flow through the process-wide EvictionBudget (actor
"descheduler") and the apiserver's PDB-respecting eviction subresource —
never raw pod deletes.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Set

from ..api import objects as v1
from ..api.selectors import match_labels
from ..client.apiserver import (
    LeaderFenced,
    NotFound,
    NotPrimary,
    TooManyRequests,
)
from ..runtime.consensus import DegradedWrites
from ..utils.metrics import metrics
from .planner import ConsolidationPlan, gang_census, gang_strands
from .planner import is_daemonset_pod, movable
from ..autoscaler.planner import simulate_drain_set

logger = logging.getLogger("kubernetes_tpu.descheduler.executor")

COUNTER_PLAN_ABORTS = "descheduler_plan_aborts_total"
COUNTER_ROLLBACK_UNCORDONS = "descheduler_rollback_uncordons_total"
COUNTER_EVICTIONS = "descheduler_evictions_total"
COUNTER_NODES_REMOVED = "descheduler_nodes_removed_total"
COUNTER_WAVES = "descheduler_waves_total"
COUNTER_PDB_PAUSES = "descheduler_pdb_wave_pauses_total"
COUNTER_STORE_SKIPS = "descheduler_degraded_write_skips_total"
COUNTER_COST_SAVED = "descheduler_cost_saved_milli_total"
COUNTER_PLANS_DONE = "descheduler_plans_completed_total"

# stamped with the cordon so (a) rollback only ever uncordons nodes WE
# cordoned, and (b) a crashed/fenced incarnation's cordons are durable
# state the next incarnation's orphan sweep can find and undo — the same
# adoption trick as the autoscaler's ANN_SCALE_DOWN
ANN_DEFRAG = "descheduler.kubernetes-tpu.io/defrag"


class PlanExecutor:
    """Drives one ConsolidationPlan at a time through verified waves."""

    def __init__(self, server, scheduler, sim, budget, catalog=None):
        self.server = server
        self.scheduler = scheduler
        self.sim = sim
        self.budget = budget
        self.catalog = catalog  # NodeGroupCatalog for deprovision hooks
        self.plan: Optional[ConsolidationPlan] = None
        self._cordoned: Set[str] = set()
        self._done: Set[str] = set()  # plan nodes already emptied + deleted

    @property
    def active(self) -> bool:
        return self.plan is not None

    def adopt(self, plan: ConsolidationPlan) -> None:
        assert self.plan is None, "one plan at a time"
        self.plan = plan
        self._cordoned.clear()
        self._done.clear()

    # -- orphan / rollback sweep ---------------------------------------------

    def sweep(self, nodes: List[v1.Node]) -> None:
        """Uncordon every node carrying OUR annotation that no active plan
        claims: rollback uncordons that hit a degraded store retry here,
        and cordons orphaned by a crash or fencing get undone by the next
        incarnation. Caller has already passed the leadership fence."""
        active = set(self.plan.nodes) if self.plan is not None else set()
        for node in nodes:
            name = node.metadata.name
            if name in active:
                continue
            if node.metadata.annotations.get(ANN_DEFRAG) == "true":
                self._uncordon(name)

    def _uncordon(self, name: str) -> bool:
        def mutate(n):
            if n.metadata.annotations.get(ANN_DEFRAG) != "true":
                return None  # not ours (anymore) — never undo operator cordons
            n.metadata.annotations.pop(ANN_DEFRAG, None)
            n.spec.unschedulable = False
            return n

        try:
            self.server.guaranteed_update("nodes", "", name, mutate)
        except NotFound:
            return True  # node gone: nothing left to roll back
        except (DegradedWrites, NotPrimary):
            # annotation stays on the node — the durable retry marker the
            # next sweep picks up once writes reopen
            metrics.inc(COUNTER_STORE_SKIPS, {"write": "uncordon"})
            return False
        metrics.inc(COUNTER_ROLLBACK_UNCORDONS)
        logger.info("defrag rollback: uncordoned %s", name)
        return True

    # -- one verified wave ---------------------------------------------------

    def tick(self) -> bool:
        """One wave attempt. Returns True while the plan stays latched
        (progress, pause, or nothing to do yet), False once it completed
        or aborted."""
        plan = self.plan
        if plan is None:
            return False

        # 1. leadership fence FIRST: a fenced replica writes nothing —
        # including rollback uncordons. The annotation hands the cordons
        # to the new leader's orphan sweep.
        try:
            self.scheduler.check_eviction_fence()
        except LeaderFenced:
            logger.warning(
                "defrag plan %s fenced mid-execution: leadership moved; "
                "writing nothing (new leader's sweep owns the cordons)",
                plan.nodes,
            )
            self._abort("fenced", rollback=False)
            return False

        # 2. cordon the whole evict-set before any eviction (new binds
        # must not land on nodes we are about to empty)
        for name in plan.nodes:
            if name in self._cordoned or name in self._done:
                continue
            status = self._cordon(name)
            if status == "degraded":
                return True  # plan latched; cordon retries next tick
            if status == "conflict":
                # someone else cordoned it between plan and execution —
                # an operator or the autoscaler owns this node now
                self._abort("drift")
                return False
            if status == "gone":
                self._abort("drift")
                return False
            self._cordoned.add(name)

        # 3. current residents of the remaining evict-set
        cache = self.scheduler.cache
        infos = cache.node_infos()
        remaining = [n for n in plan.nodes if n not in self._done]
        residents: List[v1.Pod] = []
        victims: List[v1.Pod] = []
        for name in remaining:
            ni = infos.get(name)
            if ni is None or ni.node is None:
                # the node vanished under the plan (operator delete,
                # lifecycle reap) — the proof is void
                self._abort("drift")
                return False
            node_victims = [p for p in ni.pods if not is_daemonset_pod(p)]
            if not node_victims:
                self._finish_node(name)
                continue
            vetted = set(plan.victims.get(name, ()))
            for p in node_victims:
                if p.metadata.key not in vetted or not movable(p):
                    # a pod the simulation never saw (direct node_name
                    # create, in-flight bind) or one nothing recreates:
                    # evicting around it is exactly the half-verified
                    # state this executor exists to forbid
                    self._abort("drift")
                    return False
            residents.extend(ni.pods)
            victims.extend(node_victims)
        remaining = [n for n in plan.nodes if n not in self._done]
        if not remaining:
            metrics.inc(COUNTER_PLANS_DONE)
            logger.info(
                "defrag plan complete: removed %s (fleet bill down %d "
                "milli$/h)", plan.nodes, plan.cost_drop_milli,
            )
            self.plan = None
            self._cordoned.clear()
            self._done.clear()
            return False
        if not victims:
            return True  # deletions in flight; cache catches up next tick

        # 4. gang quorum against the FRESH census (members may have been
        # scaled, deleted, or re-labeled since planning)
        strands = gang_strands(
            {
                name: [
                    p
                    for p in victims
                    if p.spec.node_name == name
                ]
                for name in remaining
            },
            gang_census(infos),
        )
        if strands:
            logger.warning(
                "defrag plan %s aborted: gang(s) %s would drop below "
                "min-member quorum mid-plan", plan.nodes, strands,
            )
            self._abort("gang_change")
            return False

        # 5. drift monitor: re-prove the REMAINING evict-set through the
        # production kernel before every wave — if the cluster changed in
        # a way that breaks re-placement (bind burst ate the headroom),
        # discard the remainder and roll back; zero evictions after the
        # divergence
        verdict = simulate_drain_set(
            self.sim, remaining, residents, kind="defrag"
        )
        if not verdict.ok:
            logger.warning(
                "defrag plan %s aborted on drift: re-simulation of "
                "remaining set failed (%s)", plan.nodes, verdict.reason,
            )
            self._abort("drift")
            return False

        # 6. PDB re-check before the wave: recompute the kernel's
        # pdb_blocked column from the disruption controller's CURRENT
        # budgets, and pause the wave host-side if any victim sits under
        # an exhausted budget (the store's eviction gate remains the
        # authoritative backstop underneath)
        try:
            pdbs, _ = self.server.list("poddisruptionbudgets")
        except Exception:
            logger.exception("PDB list failed; pausing wave")
            return True
        with cache.lock:
            cache.encoder.update_pdb_blocked(pdbs)
        exhausted = [
            (pdb.metadata.namespace, pdb.spec.selector)
            for pdb in pdbs
            if pdb.status.disruptions_allowed <= 0
        ]
        if exhausted and any(
            ns == p.metadata.namespace and match_labels(sel, p.metadata.labels)
            for p in victims
            for ns, sel in exhausted
        ):
            metrics.inc(COUNTER_PDB_PAUSES)
            return True  # plan stays latched; budgets refill, we resume

        # 7. the eviction wave: budgeted, through the PDB-respecting
        # eviction subresource, in plan order
        metrics.inc(COUNTER_WAVES)
        for pod in victims:
            if not self.budget.try_acquire(actor="descheduler"):
                return True  # shared bucket dry: resume next tick
            try:
                self.server.evict_pod(
                    pod.metadata.namespace, pod.metadata.name
                )
            except NotFound:
                continue  # already gone — that's the goal
            except TooManyRequests:
                # raced the disruption controller past our host-side
                # check; the store gate held — pause, don't abort
                metrics.inc(COUNTER_PDB_PAUSES)
                return True
            except (DegradedWrites, NotPrimary):
                metrics.inc(COUNTER_STORE_SKIPS, {"write": "evict"})
                return True  # pause-and-resume: plan stays latched
            metrics.inc(COUNTER_EVICTIONS)
        return True

    # -- node state transitions ----------------------------------------------

    def _cordon(self, name: str) -> str:
        """Returns ok | degraded | conflict | gone."""
        outcome = {"status": "ok"}

        def mutate(n):
            if n.metadata.annotations.get(ANN_DEFRAG) == "true":
                return None  # ours already (retry after degraded pause)
            if n.spec.unschedulable:
                outcome["status"] = "conflict"
                return None
            n.spec.unschedulable = True
            n.metadata.annotations[ANN_DEFRAG] = "true"
            return n

        try:
            self.server.guaranteed_update("nodes", "", name, mutate)
        except NotFound:
            return "gone"
        except (DegradedWrites, NotPrimary):
            metrics.inc(COUNTER_STORE_SKIPS, {"write": "cordon"})
            return "degraded"
        if outcome["status"] == "ok":
            logger.info("defrag: cordoned %s", name)
        return outcome["status"]

    def _finish_node(self, name: str) -> None:
        """The node drained clean: delete it (+ deprovision hook) and bank
        the savings. A degraded store just defers to the next tick."""
        plan = self.plan
        group = None
        if self.catalog is not None:
            ni = self.scheduler.cache.get_node_info(name)
            node = ni.node if ni is not None else None
            if node is not None:
                group = self.catalog.group_of_node(node)
        try:
            self.server.delete("nodes", "", name)
        except NotFound:
            pass
        except (DegradedWrites, NotPrimary):
            metrics.inc(COUNTER_STORE_SKIPS, {"write": "node_delete"})
            return
        self._done.add(name)
        if group is not None and group.deprovision is not None:
            try:
                group.deprovision(name)
            except Exception:
                logger.exception("deprovision hook failed for %s", name)
        metrics.inc(COUNTER_NODES_REMOVED)
        metrics.inc(
            COUNTER_COST_SAVED,
            by=float(plan.node_cost_milli.get(name, 0)),
        )
        logger.info("defrag: removed drained node %s", name)

    # -- abort ---------------------------------------------------------------

    def _abort(self, reason: str, rollback: bool = True) -> None:
        plan = self.plan
        metrics.inc(COUNTER_PLAN_ABORTS, {"reason": reason})
        if rollback and plan is not None:
            for name in plan.nodes:
                if name in self._done:
                    continue  # already deleted — nothing to uncordon
                self._uncordon(name)  # failures stay annotated for sweep()
        self.plan = None
        self._cordoned.clear()
        self._done.clear()
