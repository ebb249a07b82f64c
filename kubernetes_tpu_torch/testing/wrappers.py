"""Fluent test builders: PodWrapper / NodeWrapper.

Reference: pkg/scheduler/testing/wrappers.go:136,361 — table-driven tests
build specs with chained wrappers instead of struct literals. Same shape
here; `.obj()` yields the real API object.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..api import objects as v1
from ..api.selectors import LabelSelector


class PodWrapper:
    def __init__(self, name: str = "pod", namespace: str = "default"):
        self._pod = v1.Pod(
            metadata=v1.ObjectMeta(name=name, namespace=namespace),
            spec=v1.PodSpec(containers=[v1.Container()]),
        )

    def obj(self) -> v1.Pod:
        return self._pod

    # -- metadata ------------------------------------------------------------

    def namespace(self, ns: str) -> "PodWrapper":
        self._pod.metadata.namespace = ns
        return self

    def label(self, key: str, value: str) -> "PodWrapper":
        self._pod.metadata.labels[key] = value
        return self

    def labels(self, labels: Dict[str, str]) -> "PodWrapper":
        self._pod.metadata.labels.update(labels)
        return self

    def annotation(self, key: str, value: str) -> "PodWrapper":
        self._pod.metadata.annotations[key] = value
        return self

    def owner(self, kind: str, name: str, controller: bool = True) -> "PodWrapper":
        self._pod.metadata.owner_references.append(
            v1.OwnerReference(kind=kind, name=name, controller=controller)
        )
        return self

    # -- spec ----------------------------------------------------------------

    def req(self, **resources) -> "PodWrapper":
        """`.req(cpu="500m", memory="1Gi")`"""
        self._pod.spec.containers[0].requests.update(resources)
        return self

    def container_image(self, image: str) -> "PodWrapper":
        self._pod.spec.containers[0].image = image
        return self

    def host_port(self, port: int, protocol: str = "TCP") -> "PodWrapper":
        self._pod.spec.containers[0].ports.append(
            v1.ContainerPort(container_port=port, host_port=port, protocol=protocol)
        )
        return self

    def node(self, name: str) -> "PodWrapper":
        self._pod.spec.node_name = name
        return self

    def node_selector(self, sel: Dict[str, str]) -> "PodWrapper":
        self._pod.spec.node_selector.update(sel)
        return self

    def priority(self, value: int) -> "PodWrapper":
        self._pod.spec.priority = value
        return self

    def scheduler_name(self, name: str) -> "PodWrapper":
        self._pod.spec.scheduler_name = name
        return self

    def toleration(
        self, key: str, operator: str = "Exists", value: str = "", effect: str = ""
    ) -> "PodWrapper":
        self._pod.spec.tolerations.append(
            v1.Toleration(key=key, operator=operator, value=value, effect=effect)
        )
        return self

    def _affinity(self) -> dict:
        a = self._pod.spec.affinity
        return {
            "node": a.node_affinity if a else None,
            "pod": a.pod_affinity if a else None,
            "anti": a.pod_anti_affinity if a else None,
        }

    def _set_affinity(self, node=None, pod=None, anti=None) -> None:
        cur = self._affinity()
        self._pod.spec.affinity = v1.Affinity(
            node_affinity=node or cur["node"],
            pod_affinity=pod or cur["pod"],
            pod_anti_affinity=anti or cur["anti"],
        )

    def pod_affinity(
        self, topology_key: str, match_labels: Dict[str, str]
    ) -> "PodWrapper":
        term = v1.PodAffinityTerm(
            label_selector=LabelSelector.make(match_labels=match_labels),
            topology_key=topology_key,
        )
        cur = self._affinity()["pod"]
        required = (cur.required if cur else ()) + (term,)
        self._set_affinity(
            pod=v1.PodAffinity(
                required=required, preferred=cur.preferred if cur else ()
            )
        )
        return self

    def pod_anti_affinity(
        self, topology_key: str, match_labels: Dict[str, str]
    ) -> "PodWrapper":
        term = v1.PodAffinityTerm(
            label_selector=LabelSelector.make(match_labels=match_labels),
            topology_key=topology_key,
        )
        cur = self._affinity()["anti"]
        required = (cur.required if cur else ()) + (term,)
        self._set_affinity(
            anti=v1.PodAntiAffinity(
                required=required, preferred=cur.preferred if cur else ()
            )
        )
        return self

    def spread_constraint(
        self,
        max_skew: int,
        topology_key: str,
        when_unsatisfiable: str = v1.DO_NOT_SCHEDULE,
        match_labels: Optional[Dict[str, str]] = None,
    ) -> "PodWrapper":
        self._pod.spec.topology_spread_constraints.append(
            v1.TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=(
                    LabelSelector.make(match_labels=match_labels)
                    if match_labels
                    else None
                ),
            )
        )
        return self

    def pvc(self, claim_name: str) -> "PodWrapper":
        self._pod.spec.volumes.append(
            v1.Volume(name=claim_name, persistent_volume_claim=claim_name)
        )
        return self

    # -- status --------------------------------------------------------------

    def phase(self, phase: str) -> "PodWrapper":
        self._pod.status.phase = phase
        return self

    def ip(self, pod_ip: str) -> "PodWrapper":
        self._pod.status.pod_ip = pod_ip
        return self


class NodeWrapper:
    def __init__(self, name: str = "node"):
        self._node = v1.Node(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.NodeSpec(),
            status=v1.NodeStatus(
                allocatable={"cpu": "8", "memory": "32Gi", "pods": 110}
            ),
        )

    def obj(self) -> v1.Node:
        return self._node

    def label(self, key: str, value: str) -> "NodeWrapper":
        self._node.metadata.labels[key] = value
        return self

    def zone(self, zone: str) -> "NodeWrapper":
        return self.label("zone", zone)

    def capacity(self, **resources) -> "NodeWrapper":
        """`.capacity(cpu="4", memory="16Gi", pods=64)`"""
        self._node.status.allocatable.update(resources)
        return self

    def taint(
        self, key: str, value: str = "", effect: str = v1.TAINT_NO_SCHEDULE
    ) -> "NodeWrapper":
        self._node.spec.taints.append(v1.Taint(key, value, effect))
        return self

    def unschedulable(self, flag: bool = True) -> "NodeWrapper":
        self._node.spec.unschedulable = flag
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        self._node.status.images.append(
            v1.ContainerImage(names=[name], size_bytes=size_bytes)
        )
        return self
