"""DaemonSet controller: one pod per eligible node.

Reference: pkg/controller/daemon/daemon_controller.go (syncDaemonSet /
podsShouldBeOnNode). Eligibility = node matches the template's nodeSelector
and the pod's tolerations cover the node's NoSchedule/NoExecute taints.
Pods are created with a required node affinity match_fields term pinning
metadata.name to the target node, then flow through the normal scheduler —
the v1.18-era ScheduleDaemonSetPods path (the controller no longer sets
spec.nodeName itself).
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.daemonset")


def node_eligible(node: v1.Node, spec: v1.PodSpec) -> bool:
    """podsShouldBeOnNode's predicate subset: nodeSelector + taints."""
    for k, want in spec.node_selector.items():
        if node.metadata.labels.get(k) != want:
            return False
    taint = v1.find_untolerated_taint(node.spec.taints, spec.tolerations)
    return taint is None


class DaemonSetController(WorkqueueController):
    name = "daemonset"
    primary_kind = "daemonsets"
    secondary_kinds = ("pods", "nodes")
    owner_kind = "DaemonSet"

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        if resource == "nodes":
            # any node event can change eligibility for every DaemonSet
            dss, _ = self.server.list("daemonsets")
            for ds in dss:
                self.queue.add(ds.metadata.key)
            return None
        return super().enqueue_for_related(resource, obj)

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            ds = self.server.get("daemonsets", ns, name)
        except NotFound:
            return
        nodes, _ = self.server.list("nodes")
        pods = self.owned_pods(ns, "DaemonSet", name)
        by_node: Dict[str, List[v1.Pod]] = {}
        for p in pods:
            target = p.spec.node_name or _pinned_node(p)
            by_node.setdefault(target or "", []).append(p)

        eligible = {
            n.metadata.name for n in nodes if node_eligible(n, ds.spec.template.spec)
        }
        # create where missing
        for node_name in sorted(eligible):
            if not by_node.get(node_name):
                self._create_pod(ds, node_name)
        # remove where no longer eligible, plus duplicates
        misscheduled = 0
        for node_name, node_pods in by_node.items():
            if node_name and node_name not in eligible:
                misscheduled += len(node_pods)
                for p in node_pods:
                    self._delete_pod(p)
            else:
                for p in node_pods[1:]:
                    self._delete_pod(p)

        scheduled = sum(
            1 for n, ps in by_node.items() if n in eligible and ps
        )
        ready = sum(
            1
            for n, ps in by_node.items()
            if n in eligible and ps and pod_is_ready(ps[0])
        )

        def mutate(cur):
            st = cur.status
            new = (
                scheduled,
                len(eligible),
                ready,
                misscheduled,
                cur.metadata.generation,
            )
            old = (
                st.current_number_scheduled,
                st.desired_number_scheduled,
                st.number_ready,
                st.number_misscheduled,
                st.observed_generation,
            )
            if new == old:
                return None
            (
                st.current_number_scheduled,
                st.desired_number_scheduled,
                st.number_ready,
                st.number_misscheduled,
                st.observed_generation,
            ) = new
            return cur

        try:
            self.server.guaranteed_update("daemonsets", ns, name, mutate)
        except NotFound:
            pass

    def _create_pod(self, ds: v1.DaemonSet, node_name: str) -> None:
        tmpl = ds.spec.template
        spec = copy.deepcopy(tmpl.spec)
        # pin to the node via required affinity (ScheduleDaemonSetPods,
        # daemon_controller.go nodeAffinity replacement)
        pin = v1.NodeSelector(
            terms=(
                v1.NodeSelectorTerm(
                    match_fields=(
                        v1.NodeSelectorRequirement(
                            key="metadata.name", operator="In", values=(node_name,)
                        ),
                    )
                ),
            )
        )
        aff = spec.affinity or v1.Affinity()
        spec.affinity = v1.Affinity(
            node_affinity=v1.NodeAffinity(
                required=pin,
                preferred=(
                    aff.node_affinity.preferred if aff.node_affinity else ()
                ),
            ),
            pod_affinity=aff.pod_affinity,
            pod_anti_affinity=aff.pod_anti_affinity,
        )
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{ds.metadata.name}-{node_name}",
                namespace=ds.metadata.namespace,
                labels=dict(tmpl.metadata.labels or ds.spec.selector),
                owner_references=[
                    v1.OwnerReference(
                        kind="DaemonSet",
                        name=ds.metadata.name,
                        uid=ds.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=spec,
        )
        try:
            self.server.create("pods", pod)
        except AlreadyExists:
            pass

    def _delete_pod(self, pod: v1.Pod) -> None:
        try:
            self.server.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except NotFound:
            pass


def _pinned_node(pod: v1.Pod) -> Optional[str]:
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required:
        for term in aff.node_affinity.required.terms:
            for req in term.match_fields:
                if req.key == "metadata.name" and req.operator == "In" and req.values:
                    return req.values[0]
    return None
