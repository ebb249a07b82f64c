"""Config-driven benchmark workloads.

Mirrors test/integration/scheduler_perf/config/performance-config.yaml: the
same suite shapes (SchedulingBasic, PodAntiAffinity, PodAffinity,
PreferredPodAffinity, TopologySpread, NodeAffinity, Gang) at 500/5000-node
scales, with the reference's benchmark node shape (110 pods, 4 CPU, 32Gi —
scheduler_test.go:52-68). Each workload yields (nodes, init_pods,
measured_pod_factory).

Copied from ``kubernetes_tpu/perf/workloads.py`` (``WorkloadConfig``,
``build_workload``, ``WORKLOADS``). The autoscaler and heterogeneity node
catalogs stay with the reference until the port has an autoscaler; the Gang
workload's two label names are copied from the coscheduling plugin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api.objects import (
    Affinity,
    Container,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    PreferredSchedulingTerm,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from ..api.selectors import LabelSelector


# kubernetes_tpu/scheduler/framework/plugins/coscheduling.py
GROUP_LABEL = "scheduling.k8s.io/group-name"
MIN_MEMBER_ANNOTATION = "scheduling.k8s.io/min-member"


@dataclass
class WorkloadConfig:
    name: str
    num_nodes: int = 500
    num_init_pods: int = 0
    num_measured_pods: int = 1000
    zones: int = 10


def make_bench_node(name: str, zone: str) -> Node:
    return Node(
        metadata=ObjectMeta(
            name=name,
            namespace="",
            labels={
                "topology.kubernetes.io/zone": zone,
                "kubernetes.io/hostname": name,
            },
        ),
        spec=NodeSpec(),
        status=NodeStatus(allocatable={"cpu": "4", "memory": "32Gi", "pods": 110}),
    )


def _basic_pod(name: str, labels: Optional[dict] = None, **kw) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, labels=labels or {}),
        spec=PodSpec(
            containers=[Container(requests={"cpu": "100m", "memory": "128Mi"})],
            **kw,
        ),
    )


def build_workload(
    cfg: WorkloadConfig,
) -> Tuple[List[Node], List[Pod], Callable[[int], Pod]]:
    nodes = [
        make_bench_node(f"node-{i}", f"zone-{i % cfg.zones}")
        for i in range(cfg.num_nodes)
    ]
    sel = LabelSelector.make(match_labels={"app": "bench"})

    if cfg.name == "SchedulingBasic":
        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, lambda i: _basic_pod(f"pod-{i}")

    if cfg.name == "SchedulingPodAntiAffinity":
        # anti-affinity on hostname: classic one-per-node packing
        aff = Affinity(
            pod_anti_affinity=PodAntiAffinity(
                required=(
                    PodAffinityTerm(
                        label_selector=sel, topology_key="kubernetes.io/hostname"
                    ),
                )
            )
        )
        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, lambda i: _basic_pod(
            f"pod-{i}", labels={"app": "bench"}, affinity=aff
        )

    if cfg.name == "SchedulingPodAffinity":
        aff = Affinity(
            pod_affinity=PodAffinity(
                required=(
                    PodAffinityTerm(
                        label_selector=sel,
                        topology_key="topology.kubernetes.io/zone",
                    ),
                )
            )
        )
        init = [
            _basic_pod(f"init-{i}", labels={"app": "bench"})
            for i in range(max(cfg.num_init_pods, cfg.zones))
        ]
        return nodes, init, lambda i: _basic_pod(
            f"pod-{i}", labels={"app": "bench"}, affinity=aff
        )

    if cfg.name == "SchedulingPreferredPodAffinity":
        aff = Affinity(
            pod_affinity=PodAffinity(
                preferred=(
                    WeightedPodAffinityTerm(
                        1,
                        PodAffinityTerm(
                            label_selector=sel,
                            topology_key="topology.kubernetes.io/zone",
                        ),
                    ),
                )
            ),
            pod_anti_affinity=PodAntiAffinity(
                preferred=(
                    WeightedPodAffinityTerm(
                        1,
                        PodAffinityTerm(
                            label_selector=sel,
                            topology_key="kubernetes.io/hostname",
                        ),
                    ),
                )
            ),
        )
        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, lambda i: _basic_pod(
            f"pod-{i}", labels={"app": "bench"}, affinity=aff
        )

    if cfg.name == "TopologySpreading":
        tsc = TopologySpreadConstraint(
            max_skew=1,
            topology_key="topology.kubernetes.io/zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=sel,
        )
        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, lambda i: _basic_pod(
            f"pod-{i}",
            labels={"app": "bench"},
            topology_spread_constraints=[tsc],
        )

    if cfg.name == "SchedulingNodeAffinity":
        aff = Affinity(
            node_affinity=NodeAffinity(
                required=NodeSelector(
                    terms=(
                        NodeSelectorTerm(
                            match_expressions=(
                                NodeSelectorRequirement(
                                    "topology.kubernetes.io/zone",
                                    "In",
                                    tuple(f"zone-{z}" for z in range(cfg.zones // 2)),
                                ),
                            )
                        ),
                    )
                )
            )
        )
        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, lambda i: _basic_pod(f"pod-{i}", affinity=aff)

    if cfg.name == "SchedulingSecrets":
        # pods mounting secret volumes (performance-config.yaml
        # SchedulingSecrets): volumes ride the encode path but gate
        # nothing — isolates the spec-size cost from scheduling logic
        from ..api.objects import Volume

        def secret_factory(i: int) -> Pod:
            p = _basic_pod(f"pod-{i}")
            p.spec.volumes = [
                Volume(name=f"s{j}", secret=f"sec-{j}") for j in range(2)
            ]
            return p

        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, secret_factory

    if cfg.name == "SchedulingInTreePVs":
        # direct in-tree volumes (performance-config.yaml in-tree PV
        # variant): these pods are flagged for the HOST fallback path
        # (volume plugins — GCEPDLimits etc. — are host-side post-filters),
        # so this workload measures the fallback lane at bench scale
        from ..api.objects import GCEPersistentDiskVolumeSource, Volume

        def pv_factory(i: int) -> Pod:
            p = _basic_pod(f"pod-{i}")
            p.spec.volumes = [
                Volume(
                    name="data",
                    gce_persistent_disk=GCEPersistentDiskVolumeSource(
                        pd_name=f"disk-{i}"
                    ),
                )
            ]
            return p

        init = [_basic_pod(f"init-{i}") for i in range(cfg.num_init_pods)]
        return nodes, init, pv_factory

    if cfg.name == "Gang":
        # gang burst: groups of 50 identical pods (PodGroup-style), all
        # pending at once (BASELINE.md: 15k pending pods on 5k nodes);
        # membership/quorum per the Coscheduling plugin's contract
        def factory(i: int) -> Pod:
            g = i // 50
            p = _basic_pod(
                f"pod-{i}", labels={"app": "bench", GROUP_LABEL: f"g{g}"}
            )
            p.metadata.annotations[MIN_MEMBER_ANNOTATION] = "50"
            return p

        return nodes, [], factory

    raise KeyError(f"unknown workload {cfg.name}")


WORKLOADS: Dict[str, WorkloadConfig] = {
    "SchedulingBasic/500": WorkloadConfig("SchedulingBasic", 500, 250, 1000),
    "SchedulingBasic/5000": WorkloadConfig("SchedulingBasic", 5000, 1000, 5000),
    "SchedulingPodAntiAffinity/500": WorkloadConfig(
        "SchedulingPodAntiAffinity", 500, 100, 400
    ),
    "SchedulingPodAntiAffinity/5000": WorkloadConfig(
        "SchedulingPodAntiAffinity", 5000, 1000, 4000
    ),
    "SchedulingPodAffinity/500": WorkloadConfig("SchedulingPodAffinity", 500, 100, 1000),
    "SchedulingPodAffinity/5000": WorkloadConfig(
        "SchedulingPodAffinity", 5000, 1000, 5000
    ),
    "SchedulingPreferredPodAffinity/5000": WorkloadConfig(
        "SchedulingPreferredPodAffinity", 5000, 1000, 5000
    ),
    "TopologySpreading/5000": WorkloadConfig("TopologySpreading", 5000, 1000, 5000),
    "SchedulingNodeAffinity/5000": WorkloadConfig(
        "SchedulingNodeAffinity", 5000, 1000, 5000
    ),
    "SchedulingSecrets/500": WorkloadConfig("SchedulingSecrets", 500, 100, 1000),
    "SchedulingSecrets/5000": WorkloadConfig("SchedulingSecrets", 5000, 1000, 5000),
    "SchedulingInTreePVs/500": WorkloadConfig("SchedulingInTreePVs", 500, 100, 400),
    "Gang/5000": WorkloadConfig("Gang", 5000, 0, 15000),
    # the reference's large density gate: 30k pods / 1000 nodes
    # (test/integration/scheduler_perf/scheduler_test.go:93-103)
    "SchedulingDensity/1000": WorkloadConfig("SchedulingBasic", 1000, 0, 30000),
}
