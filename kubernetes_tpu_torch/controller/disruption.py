"""Disruption controller: keep PodDisruptionBudget status live.

Reference: pkg/controller/disruption/disruption.go (trySync/updatePdbStatus)
— for each PDB, count healthy matching pods, derive the desired healthy
count from minAvailable/maxUnavailable, and publish disruptionsAllowed.
The scheduler's preemption path reads disruptionsAllowed to prefer victims
whose eviction stays within budget (generic_scheduler.go:721
pickOneNodeForPreemption criterion #1, filterPodsWithPDBViolation).

expectedPods resolves through the pods' controller scale when available
(Deployment/ReplicaSet/StatefulSet spec.replicas), else falls back to the
matching-pod count — the reference's getExpectedScale behavior reduced to
the kinds this framework serves.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..api import objects as v1
from ..client.apiserver import NotFound
from .base import WorkqueueController, match_labels, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.disruption")

_SCALE_KINDS = {
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "StatefulSet": "statefulsets",
}


class DisruptionController(WorkqueueController):
    name = "disruption"
    primary_kind = "poddisruptionbudgets"
    secondary_kinds = ("pods",)

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        pdbs, _ = self.server.list(
            "poddisruptionbudgets", namespace=obj.metadata.namespace
        )
        for pdb in pdbs:
            if match_labels(pdb.spec.selector, obj.metadata.labels):
                self.queue.add(pdb.metadata.key)
        return None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            pdb = self.server.get("poddisruptionbudgets", ns, name)
        except NotFound:
            return
        pods, _ = self.server.list("pods", namespace=ns)
        matching = [
            p
            for p in pods
            if p.metadata.deletion_timestamp is None
            and match_labels(pdb.spec.selector, p.metadata.labels)
        ]
        healthy = sum(1 for p in matching if pod_is_ready(p))
        expected = self._expected_scale(matching) or len(matching)

        if pdb.spec.min_available is not None:
            desired = min(pdb.spec.min_available, expected)
        elif pdb.spec.max_unavailable is not None:
            desired = max(0, expected - pdb.spec.max_unavailable)
        else:
            desired = expected  # no budget field: nothing may be disrupted
        allowed = max(0, healthy - desired)

        def mutate(cur):
            st = cur.status
            new = (allowed, healthy, desired, expected, cur.metadata.generation)
            old = (
                st.disruptions_allowed,
                st.current_healthy,
                st.desired_healthy,
                st.expected_pods,
                st.observed_generation,
            )
            if new == old:
                return None
            (
                st.disruptions_allowed,
                st.current_healthy,
                st.desired_healthy,
                st.expected_pods,
                st.observed_generation,
            ) = new
            return cur

        try:
            self.server.guaranteed_update("poddisruptionbudgets", ns, name, mutate)
        except NotFound:
            pass

    def _expected_scale(self, pods: List[v1.Pod]) -> int:
        total = 0
        seen = set()
        for p in pods:
            ref = next(
                (r for r in p.metadata.owner_references if r.controller), None
            )
            if ref is None:
                total += 1
                continue
            k = (ref.kind, ref.name)
            if k in seen:
                continue
            seen.add(k)
            resource = _SCALE_KINDS.get(ref.kind)
            if resource is None:
                total += 1
                continue
            try:
                owner = self.server.get(
                    resource, p.metadata.namespace, ref.name
                )
                total += owner.spec.replicas
            except NotFound:
                total += 1
        return total
