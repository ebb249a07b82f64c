"""ClusterRole aggregation controller.

Reference: pkg/controller/clusterroleaggregation/clusterroleaggregation_controller.go
— a ClusterRole carrying an aggregationRule owns no rules of its own;
the controller unions the rules of every ClusterRole whose labels match
any of the rule's selectors and overwrites the aggregate's rules with the
result (how admin/edit/view pick up CRD-granted permissions). Any
ClusterRole event re-syncs all aggregating roles, since the changed role
may match (or no longer match) someone's selector.
"""

from __future__ import annotations

import logging
from typing import List

from ..api import objects as v1
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.rbac")


def _rule_key(r: v1.PolicyRule):
    return (
        tuple(sorted(r.verbs)),
        tuple(sorted(r.resources)),
        tuple(sorted(r.resource_names)),
        tuple(sorted(r.api_groups)),
    )


class ClusterRoleAggregationController(WorkqueueController):
    name = "clusterrole-aggregation"
    primary_kind = "clusterroles"
    secondary_kinds = ()

    def __init__(self, server, workers: int = 1):
        super().__init__(server, workers=workers)

    def _enqueue_aggregating(self) -> None:
        for role in self.server.list("clusterroles")[0]:
            if role.aggregation_rule is not None:
                self.queue.add(role.metadata.key)

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            role = self.server.get("clusterroles", ns, name)
        except NotFound:
            # a deleted role may have fed any aggregate
            self._enqueue_aggregating()
            return
        if role.aggregation_rule is None:
            # a changed source role may match (or no longer match) any
            # aggregate's selectors: fan out from the worker, not the
            # watch thread (the reference lists-and-enqueues the same way)
            self._enqueue_aggregating()
            return
        selectors = role.aggregation_rule.cluster_role_selectors
        if not selectors:
            return
        union: List[v1.PolicyRule] = []
        seen = set()
        for other in sorted(
            self.server.list("clusterroles")[0], key=lambda r: r.metadata.name
        ):
            if other.metadata.name == role.metadata.name:
                continue  # never aggregate into yourself
            if not any(s.matches(other.metadata.labels) for s in selectors):
                continue
            for r in other.rules:
                k = _rule_key(r)
                if k not in seen:
                    seen.add(k)
                    union.append(r)
        if [_rule_key(r) for r in role.rules] == [_rule_key(r) for r in union]:
            return  # converged: nothing to propagate to chained aggregates

        def mutate(cur):
            if cur.aggregation_rule is None:
                return None
            if [_rule_key(r) for r in cur.rules] == [
                _rule_key(r) for r in union
            ]:
                return None
            cur.rules = [
                v1.PolicyRule(
                    verbs=list(r.verbs),
                    resources=list(r.resources),
                    resource_names=list(r.resource_names),
                    api_groups=list(r.api_groups),
                )
                for r in union
            ]
            return cur

        try:
            self.server.guaranteed_update("clusterroles", ns, name, mutate)
            logger.info(
                "aggregated %d rules into ClusterRole %s", len(union), name
            )
        except NotFound:
            pass
        # this role may itself feed other aggregates (admin <- edit <-
        # view chaining): fan out after an actual rules change. Fanning
        # out only on change keeps the loop convergent — a no-op sync
        # never re-enqueues
        self._enqueue_aggregating()
