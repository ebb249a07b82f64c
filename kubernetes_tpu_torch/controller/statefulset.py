"""StatefulSet controller: ordinal pods with ordered rollout.

Reference: pkg/controller/statefulset/stateful_set_control.go
(UpdateStatefulSet) — pods are named <set>-<ordinal>; OrderedReady policy
creates ordinal i only when 0..i-1 are Running, and scales down from the
highest ordinal first. Volume claim templates / revisions are out of scope
(no dynamic provisioner in this framework — documented divergence).
"""

from __future__ import annotations

import copy
import logging
import re

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.statefulset")

_ORDINAL_RE = re.compile(r"-(\d+)$")


class StatefulSetController(WorkqueueController):
    name = "statefulset"
    primary_kind = "statefulsets"
    secondary_kinds = ("pods",)
    owner_kind = "StatefulSet"

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            st = self.server.get("statefulsets", ns, name)
        except NotFound:
            return
        pods = self.owned_pods(ns, "StatefulSet", name)
        by_ordinal = {}
        for p in pods:
            m = _ORDINAL_RE.search(p.metadata.name)
            if m:
                by_ordinal[int(m.group(1))] = p

        want = st.spec.replicas
        ordered = st.spec.pod_management_policy == "OrderedReady"

        # scale down: highest ordinal first, one at a time when ordered
        extra = sorted((o for o in by_ordinal if o >= want), reverse=True)
        for o in extra:
            self._delete_pod(by_ordinal[o])
            if ordered:
                break

        # scale up / heal: create missing ordinals in order
        for o in range(want):
            p = by_ordinal.get(o)
            if p is None:
                self._create_pod(st, o)
                if ordered:
                    break
            elif ordered and not pod_is_ready(p):
                break  # wait for this ordinal before creating the next

        ready = sum(
            1 for o, p in by_ordinal.items() if o < want and pod_is_ready(p)
        )
        current = sum(1 for o in by_ordinal if o < want)

        def mutate(cur):
            s = cur.status
            new = (current, ready, current, cur.metadata.generation)
            old = (
                s.replicas,
                s.ready_replicas,
                s.current_replicas,
                s.observed_generation,
            )
            if new == old:
                return None
            s.replicas, s.ready_replicas, s.current_replicas, s.observed_generation = new
            return cur

        try:
            self.server.guaranteed_update("statefulsets", ns, name, mutate)
        except NotFound:
            pass

    def _create_pod(self, st: v1.StatefulSet, ordinal: int) -> None:
        tmpl = st.spec.template
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{st.metadata.name}-{ordinal}",
                namespace=st.metadata.namespace,
                labels=dict(tmpl.metadata.labels or st.spec.selector),
                owner_references=[
                    v1.OwnerReference(
                        kind="StatefulSet",
                        name=st.metadata.name,
                        uid=st.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=copy.deepcopy(tmpl.spec),
        )
        pod.metadata.labels["statefulset.kubernetes.io/pod-name"] = pod.metadata.name
        try:
            self.server.create("pods", pod)
        except AlreadyExists:
            pass

    def _delete_pod(self, pod: v1.Pod) -> None:
        try:
            self.server.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except NotFound:
            pass
