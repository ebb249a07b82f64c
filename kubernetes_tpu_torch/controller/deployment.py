"""Deployment controller: template-hashed ReplicaSet chain + rolling update.

Reference: pkg/controller/deployment/deployment_controller.go (syncDeployment)
and rolling.go (reconcileNewReplicaSet / reconcileOldReplicaSets). A
Deployment owns one ReplicaSet per distinct pod template (identified by a
stable hash); rollout scales the new RS up within spec.replicas + maxSurge
and the old RSs down while keeping availability above
spec.replicas − maxUnavailable. Surge/unavailable are absolute counts here
(the reference also accepts percentages — intentional simplification).
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
from typing import List, Optional, Tuple

from ..api import objects as v1
from ..api.serialization import to_dict
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.deployment")


def template_hash(tmpl: v1.PodTemplateSpec) -> str:
    """Stable short hash of a pod template (pod-template-hash label value;
    reference controller.ComputeHash)."""
    d = to_dict(tmpl)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


class DeploymentController(WorkqueueController):
    name = "deployment"
    primary_kind = "deployments"
    secondary_kinds = ("replicasets",)
    owner_kind = "Deployment"

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            dep = self.server.get("deployments", ns, name)
        except NotFound:
            return  # GC cascades to RSs / pods
        if dep.spec.paused:
            return

        new_rs, old_rss = self._get_replica_sets(dep)
        if new_rs is None:
            new_rs = self._create_replica_set(dep)
            if new_rs is None:
                return
        if dep.spec.strategy.type == v1.RECREATE:
            self._rollout_recreate(dep, new_rs, old_rss)
        else:
            self._rollout_rolling(dep, new_rs, old_rss)
        self._sync_status(dep, new_rs, old_rss)

    # -- replica set management ---------------------------------------------

    def _get_replica_sets(
        self, dep: v1.Deployment
    ) -> Tuple[Optional[v1.ReplicaSet], List[v1.ReplicaSet]]:
        want_hash = template_hash(dep.spec.template)
        rss, _ = self.server.list("replicasets", namespace=dep.metadata.namespace)
        mine = [
            rs
            for rs in rss
            if any(
                r.controller and r.kind == "Deployment" and r.name == dep.metadata.name
                for r in rs.metadata.owner_references
            )
        ]
        new = next(
            (
                rs
                for rs in mine
                if rs.metadata.labels.get("pod-template-hash") == want_hash
            ),
            None,
        )
        old = [rs for rs in mine if rs is not new]
        return new, old

    def _create_replica_set(self, dep: v1.Deployment) -> Optional[v1.ReplicaSet]:
        h = template_hash(dep.spec.template)
        tmpl = copy.deepcopy(dep.spec.template)
        tmpl.metadata.labels = dict(tmpl.metadata.labels or dep.spec.selector)
        tmpl.metadata.labels["pod-template-hash"] = h
        rs = v1.ReplicaSet(
            metadata=v1.ObjectMeta(
                name=f"{dep.metadata.name}-{h}",
                namespace=dep.metadata.namespace,
                labels={**dep.spec.selector, "pod-template-hash": h},
                owner_references=[
                    v1.OwnerReference(
                        kind="Deployment",
                        name=dep.metadata.name,
                        uid=dep.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=v1.ReplicaSetSpec(
                replicas=0,
                selector={**dep.spec.selector, "pod-template-hash": h},
                template=tmpl,
            ),
        )
        try:
            return self.server.create("replicasets", rs)
        except AlreadyExists:
            try:
                return self.server.get(
                    "replicasets", rs.metadata.namespace, rs.metadata.name
                )
            except NotFound:
                return None

    def _scale_rs(self, rs: v1.ReplicaSet, replicas: int) -> None:
        if rs.spec.replicas == replicas:
            return

        def mutate(cur):
            if cur.spec.replicas == replicas:
                return None
            cur.spec.replicas = replicas
            return cur

        try:
            self.server.guaranteed_update(
                "replicasets", rs.metadata.namespace, rs.metadata.name, mutate
            )
        except NotFound:
            pass

    # -- rollout strategies ---------------------------------------------------

    def _ready_by_rs(self, dep: v1.Deployment) -> dict:
        """One pod listing per sync, partitioned by owning ReplicaSet name
        (the reference controller works from informer-indexed pod lists)."""
        pods, _ = self.server.list("pods", namespace=dep.metadata.namespace)
        out: dict = {}
        for p in pods:
            if p.metadata.deletion_timestamp is not None:
                continue
            ref = self.controller_owner(p, "ReplicaSet")
            if ref is not None and pod_is_ready(p):
                out[ref.name] = out.get(ref.name, 0) + 1
        return out

    def _rollout_rolling(
        self, dep: v1.Deployment, new_rs: v1.ReplicaSet, old_rss: List[v1.ReplicaSet]
    ) -> None:
        want = dep.spec.replicas
        surge = dep.spec.strategy.max_surge
        max_unavail = dep.spec.strategy.max_unavailable
        old_total = sum(rs.spec.replicas for rs in old_rss)

        # reconcileNewReplicaSet: scale new up to want, bounded by
        # want + surge total pods across all RSs; scale DOWN when the
        # deployment itself shrank (new RS above want with no rollout going)
        new_target = min(want, max(0, want + surge - old_total))
        if new_target > new_rs.spec.replicas or new_rs.spec.replicas > want:
            self._scale_rs(new_rs, new_target if new_target > new_rs.spec.replicas else want)

        # reconcileOldReplicaSets: scale old down as readiness allows
        ready_by_rs = self._ready_by_rs(dep)
        ready = ready_by_rs.get(new_rs.metadata.name, 0) + sum(
            ready_by_rs.get(rs.metadata.name, 0) for rs in old_rss
        )
        min_available = want - max_unavail
        can_remove = max(0, ready - min_available)
        # also remove pods beyond the surge budget regardless of readiness
        total = new_rs.spec.replicas + old_total
        can_remove = max(can_remove, total - (want + surge))
        for rs in sorted(old_rss, key=lambda r: r.metadata.creation_timestamp):
            if can_remove <= 0:
                break
            drop = min(rs.spec.replicas, can_remove)
            if drop > 0:
                self._scale_rs(rs, rs.spec.replicas - drop)
                can_remove -= drop

        self._cleanup_old(dep, old_rss)

    def _rollout_recreate(
        self, dep: v1.Deployment, new_rs: v1.ReplicaSet, old_rss: List[v1.ReplicaSet]
    ) -> None:
        # scale all old to zero first; only then bring up the new template
        for rs in old_rss:
            if rs.spec.replicas:
                self._scale_rs(rs, 0)
        old_pods = [
            p
            for rs in old_rss
            for p in self.owned_pods(
                rs.metadata.namespace, "ReplicaSet", rs.metadata.name
            )
        ]
        if not old_pods:
            self._scale_rs(new_rs, dep.spec.replicas)
        self._cleanup_old(dep, old_rss)

    def _cleanup_old(self, dep: v1.Deployment, old_rss: List[v1.ReplicaSet]) -> None:
        """revisionHistoryLimit: drop empty old RSs beyond the limit."""
        empties = [
            rs
            for rs in old_rss
            if rs.spec.replicas == 0 and rs.status.replicas == 0
        ]
        excess = len(empties) - dep.spec.revision_history_limit
        if excess <= 0:
            return
        empties.sort(key=lambda r: r.metadata.creation_timestamp)
        for rs in empties[:excess]:
            try:
                self.server.delete(
                    "replicasets", rs.metadata.namespace, rs.metadata.name
                )
            except NotFound:
                pass

    # -- status ---------------------------------------------------------------

    def _sync_status(
        self, dep: v1.Deployment, new_rs: v1.ReplicaSet, old_rss: List[v1.ReplicaSet]
    ) -> None:
        all_rss = [new_rs] + old_rss
        replicas = sum(rs.status.replicas for rs in all_rss)
        ready = sum(rs.status.ready_replicas for rs in all_rss)
        upd = self._ready_by_rs(dep).get(new_rs.metadata.name, 0)

        def mutate(cur):
            st = cur.status
            if (
                st.replicas == replicas
                and st.ready_replicas == ready
                and st.updated_replicas == upd
                and st.observed_generation == cur.metadata.generation
            ):
                return None
            st.replicas = replicas
            st.ready_replicas = ready
            st.available_replicas = ready
            st.unavailable_replicas = max(0, cur.spec.replicas - ready)
            st.updated_replicas = upd
            st.observed_generation = cur.metadata.generation
            return cur

        try:
            self.server.guaranteed_update(
                "deployments", dep.metadata.namespace, dep.metadata.name, mutate
            )
        except NotFound:
            pass
