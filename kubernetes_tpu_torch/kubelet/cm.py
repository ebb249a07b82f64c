"""Container manager: node allocatable + pod cgroup layout.

Reference: pkg/kubelet/cm/container_manager_linux.go (Node Allocatable
enforcement: allocatable = capacity - kube-reserved - system-reserved -
eviction threshold) and cm/pod_container_manager_linux.go (the
/kubepods/{qos}/pod{uid} cgroup tree). There are no real cgroups to write
here (the hollow runtime), but the ACCOUNTING is real: the allocatable the
scheduler packs against is capacity minus reservations, and every pod has
a deterministic cgroup path derived from its QoS class — the same numbers
and layout a real node would enforce.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import objects as v1
from ..api.resources import cpu_to_millis, parse_quantity
from .eviction import QOS_BEST_EFFORT, QOS_BURSTABLE, QOS_GUARANTEED, qos_class

_QOS_CGROUP = {
    QOS_GUARANTEED: "",  # guaranteed pods sit directly under kubepods
    QOS_BURSTABLE: "burstable",
    QOS_BEST_EFFORT: "besteffort",
}


class ContainerManager:
    def __init__(
        self,
        system_reserved: Optional[Dict[str, str]] = None,
        kube_reserved: Optional[Dict[str, str]] = None,
        eviction_hard_memory: str = "0",
    ):
        self.system_reserved = dict(system_reserved or {})
        self.kube_reserved = dict(kube_reserved or {})
        self.eviction_hard_memory = eviction_hard_memory

    def node_allocatable(self, capacity: Dict[str, object]) -> Dict[str, object]:
        """Allocatable = capacity - reservations (GetNodeAllocatableReservation):
        cpu in millicores, memory in bytes (memory also subtracts the hard
        eviction threshold, matching the reference's formula). Unreserved
        resources pass through unchanged."""
        out: Dict[str, object] = dict(capacity)
        cpu_res = sum(
            cpu_to_millis(r.get("cpu", 0))
            for r in (self.system_reserved, self.kube_reserved)
        )
        if "cpu" in capacity and cpu_res:
            out["cpu"] = f"{max(cpu_to_millis(capacity['cpu']) - cpu_res, 0)}m"
        mem_res = sum(
            int(parse_quantity(r.get("memory", 0)))
            for r in (self.system_reserved, self.kube_reserved)
        ) + int(parse_quantity(self.eviction_hard_memory))
        if "memory" in capacity and mem_res:
            # quantity STRING like every other allocatable in the system
            # (plain byte count is a valid k8s quantity)
            out["memory"] = str(
                max(int(parse_quantity(capacity["memory"])) - mem_res, 0)
            )
        return out

    @staticmethod
    def pod_cgroup(pod: v1.Pod) -> str:
        """/kubepods[/{qos}]/pod{uid} (pod_container_manager_linux.go
        GetPodContainerName)."""
        qos = _QOS_CGROUP[qos_class(pod)]
        parts = ["kubepods"]
        if qos:
            parts.append(qos)
        # key fallback sanitized: "ns/name" must stay ONE path segment
        ident = pod.metadata.uid or pod.metadata.key.replace("/", "_")
        parts.append(f"pod{ident}")
        return "/" + "/".join(parts)
