"""Core typed objects: Pod, Node, and the scheduling-relevant sub-structures.

Covers the slice of staging/src/k8s.io/api/core/v1/types.go the control plane
consumes: metadata, resources, taints/tolerations, node & pod affinity,
topology spread constraints, host ports, images, conditions. Plain mutable
dataclasses; Pod/Node deep-copy is a hand-rolled structural copy (every
mutable sub-object cloned, frozen ones shared — ~100x faster than
copy.deepcopy on the store's hot path; tests/test_api.py pins field
completeness); other kinds fall back to copy.deepcopy. Defaulting happens in
constructors; conversion layers are unnecessary (single internal version).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .resources import (
    CPU,
    DEFAULT_MILLI_CPU_REQUEST,
    DEFAULT_MEMORY_REQUEST,
    MEMORY,
    PODS,
    Quantity,
    ResourceList,
)
from .selectors import LabelSelector

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    api_version: str = "v1"
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    # finalizer gate: the GC may not delete the owner until this dependent
    # is gone (reference metav1.OwnerReference.BlockOwnerDeletion; enforced
    # at admission by OwnerReferencesPermissionEnforcement)
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        """namespace/name cache key (cache.MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


# ---------------------------------------------------------------------------
# Taints and tolerations (v1 types.go Taint/Toleration)
# ---------------------------------------------------------------------------

TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"

TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"

# cluster-autoscaler contract annotations/labels (autoscaler/):
# a pod with no controller owner blocks scale-down of its node unless it
# carries the safe-to-evict annotation; nodes provisioned by the autoscaler
# carry the nodegroup label so scale-down knows which catalog entry (and
# min-size floor) they count against.
ANN_SAFE_TO_EVICT = "cluster-autoscaler.kubernetes.io/safe-to-evict"
LABEL_NODEGROUP = "autoscaler.kubernetes-tpu.io/nodegroup"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty effect matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """v1/toleration.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return self.value == taint.value


def tolerations_tolerate_taint(
    tolerations: Sequence[Toleration], taint: Taint
) -> bool:
    return any(t.tolerates(taint) for t in tolerations)


def find_untolerated_taint(
    taints: Sequence[Taint],
    tolerations: Sequence[Toleration],
    effects: Sequence[str] = (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE),
) -> Optional[Taint]:
    """v1helper.FindMatchingUntoleratedTaint (filter path)."""
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            return taint
    return None


# ---------------------------------------------------------------------------
# Node affinity (v1 NodeSelector*)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In/NotIn/Exists/DoesNotExist/Gt/Lt
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    # AND of expressions; matchFields (metadata.name) folded into
    # match_fields for the single supported field.
    match_expressions: Tuple[NodeSelectorRequirement, ...] = ()
    match_fields: Tuple[NodeSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class NodeSelector:
    # OR of terms (nodeSelectorTerms)
    terms: Tuple[NodeSelectorTerm, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: Tuple[PreferredSchedulingTerm, ...] = ()


# ---------------------------------------------------------------------------
# Pod affinity (v1 PodAffinity*)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: Tuple[str, ...] = ()  # empty => pod's own namespace
    topology_key: str = ""


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# Topology spread (v1 TopologySpreadConstraint)
# ---------------------------------------------------------------------------

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


# ---------------------------------------------------------------------------
# Containers & pods
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Probe:
    """v1.Probe (types.go): the handler itself is the runtime's health
    check in this build — the kubelet asks the PodRuntime, the way the
    reference's prober execs/GETs into the container."""

    period_seconds: float = 10.0
    initial_delay_seconds: float = 0.0
    failure_threshold: int = 3
    success_threshold: int = 1


@dataclass
class ContainerStatus:
    name: str = ""
    ready: bool = False
    restart_count: int = 0
    state: str = "running"  # waiting | running | terminated


@dataclass(frozen=True)
class SecurityContext:
    """Container security context subset the admission gates act on
    (reference core/v1 SecurityContext)."""

    privileged: bool = False
    run_as_user: Optional[int] = None
    run_as_non_root: bool = False


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: Dict[str, Quantity] = field(default_factory=dict)
    limits: Dict[str, Quantity] = field(default_factory=dict)
    ports: List[ContainerPort] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    image_pull_policy: str = ""  # "" = kubelet default (IfNotPresent)
    security_context: Optional[SecurityContext] = None
    # entrypoint (v1.Container Command/Args): consumed by ProcessRuntime,
    # which supervises a real host process per container
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    # PreemptLowerPriority | Never; None = inherit the class's policy
    # (filled by the Priority admission plugin, like spec.priority)
    preemption_policy: Optional[str] = None
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list
    )
    host_network: bool = False
    restart_policy: str = "Always"
    termination_grace_period_seconds: int = 30
    volumes: List["Volume"] = field(default_factory=list)
    service_account_name: str = ""
    # bounded-duration pods (Jobs set this); the quota "Terminating" scope
    # selects on its presence (reference core/v1 ActiveDeadlineSeconds)
    active_deadline_seconds: Optional[int] = None
    # named RuntimeClass; the RuntimeClass admission plugin merges the
    # class's overhead/scheduling into the pod (node/v1 RuntimeClassName)
    runtime_class_name: str = ""


@dataclass(frozen=True)
class GCEPersistentDiskVolumeSource:
    pd_name: str = ""
    read_only: bool = False


@dataclass(frozen=True)
class AWSElasticBlockStoreVolumeSource:
    volume_id: str = ""
    read_only: bool = False


@dataclass(frozen=True)
class ISCSIVolumeSource:
    target_portal: str = ""
    iqn: str = ""
    lun: int = 0
    read_only: bool = False


@dataclass(frozen=True)
class RBDVolumeSource:
    monitors: Tuple[str, ...] = ()
    image: str = ""
    pool: str = "rbd"
    read_only: bool = False


@dataclass(frozen=True)
class AzureDiskVolumeSource:
    disk_name: str = ""
    data_disk_uri: str = ""
    read_only: bool = False


@dataclass(frozen=True)
class CinderVolumeSource:
    volume_id: str = ""
    read_only: bool = False


@dataclass(frozen=True)
class CSIVolumeSource:
    driver: str = ""
    volume_handle: str = ""
    read_only: bool = False


@dataclass
class Volume:
    name: str = ""
    # A tiny union: exactly one of these set.
    persistent_volume_claim: Optional[str] = None  # claim name
    host_path: Optional[str] = None
    empty_dir: bool = False
    config_map: Optional[str] = None
    secret: Optional[str] = None
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    iscsi: Optional[ISCSIVolumeSource] = None
    rbd: Optional[RBDVolumeSource] = None
    azure_disk: Optional[AzureDiskVolumeSource] = None
    cinder: Optional[CinderVolumeSource] = None


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"

COND_POD_SCHEDULED = "PodScheduled"
COND_POD_READY = "Ready"


@dataclass
class PodCondition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    reason: str = ""
    message: str = ""
    start_time: Optional[float] = None
    pod_ip: str = ""  # set by the node agent once the sandbox is up
    host_ip: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"

    def deep_copy(self) -> "Pod":
        """Structural copy: clone every mutable container/dataclass, share
        frozen ones (selectors, affinity, taints, volume sources — immutable
        by construction). ~100x faster than copy.deepcopy's memo walk; the
        API store copies on every create/get/list/watch-event, so this is on
        the control plane's hottest path."""
        return Pod(
            metadata=_copy_meta(self.metadata),
            spec=_copy_pod_spec(self.spec),
            status=_copy_pod_status(self.status),
            kind=self.kind,
        )

    def __deepcopy__(self, memo) -> "Pod":
        return self.deep_copy()

    @property
    def priority(self) -> int:
        """pod priority with default 0 (podutil.GetPodPriority)."""
        return self.spec.priority if self.spec.priority is not None else 0


def assume_copy(pod: Pod, node_name: str) -> Pod:
    """Shell copy for the scheduler cache's assume protocol: a fresh Pod +
    PodSpec shell with node_name set, SHARING metadata, status, and every
    spec innard (containers, volumes, tolerations, affinity — all treated
    as read-only once queued; informer updates arrive as new objects and
    the confirmation swaps in the API server's own copy, cache.add_pod).
    ~10x cheaper than deep_copy on the bulk assume path, which the host
    bind stage's pods/s ceiling is made of. dataclasses.replace keeps the
    shell complete as PodSpec grows fields."""
    return Pod(
        metadata=pod.metadata,
        spec=dataclasses.replace(pod.spec, node_name=node_name),
        status=pod.status,
        kind=pod.kind,
    )


def event_copy(pod: Pod) -> Pod:
    """Watch-event snapshot of a stored pod: fresh Pod/meta/spec/status
    SHELLS so the event is isolated from the store's in-place shell
    mutators (bind_pods' node_name set, _bump's resource_version, delete's
    deletion_timestamp), while sharing every list/dict innard — the store
    replaces objects wholesale on update and never mutates innards in
    place. This is the batch-bind hot path's copy (one per MODIFIED
    event); cold paths keep full deep_copy."""
    return Pod(
        metadata=dataclasses.replace(pod.metadata),
        spec=dataclasses.replace(pod.spec),
        status=dataclasses.replace(pod.status),
        kind=pod.kind,
    )


def _copy_meta(m: ObjectMeta) -> ObjectMeta:
    return ObjectMeta(
        name=m.name,
        namespace=m.namespace,
        uid=m.uid,
        labels=dict(m.labels),
        annotations=dict(m.annotations),
        resource_version=m.resource_version,
        generation=m.generation,
        creation_timestamp=m.creation_timestamp,
        deletion_timestamp=m.deletion_timestamp,
        owner_references=[
            OwnerReference(
                r.api_version, r.kind, r.name, r.uid, r.controller,
                r.block_owner_deletion,
            )
            for r in m.owner_references
        ],
        finalizers=list(m.finalizers),
    )


def _copy_container(c: Container) -> Container:
    return Container(
        name=c.name,
        image=c.image,
        requests=dict(c.requests),
        limits=dict(c.limits),
        ports=[
            ContainerPort(p.container_port, p.host_port, p.protocol, p.host_ip)
            for p in c.ports
        ],
        liveness_probe=c.liveness_probe,  # Probe is treated as immutable
        readiness_probe=c.readiness_probe,
        image_pull_policy=c.image_pull_policy,
        security_context=c.security_context,  # frozen
        command=list(c.command),
        args=list(c.args),
    )


def _copy_volume(v: Volume) -> Volume:
    # sources are frozen dataclasses / scalars — share them
    return Volume(
        name=v.name,
        persistent_volume_claim=v.persistent_volume_claim,
        host_path=v.host_path,
        empty_dir=v.empty_dir,
        config_map=v.config_map,
        secret=v.secret,
        gce_persistent_disk=v.gce_persistent_disk,
        aws_elastic_block_store=v.aws_elastic_block_store,
        iscsi=v.iscsi,
        rbd=v.rbd,
        azure_disk=v.azure_disk,
        cinder=v.cinder,
    )


def _copy_pod_spec(s: PodSpec) -> PodSpec:
    return PodSpec(
        node_name=s.node_name,
        scheduler_name=s.scheduler_name,
        priority=s.priority,
        priority_class_name=s.priority_class_name,
        preemption_policy=s.preemption_policy,
        containers=[_copy_container(c) for c in s.containers],
        init_containers=[_copy_container(c) for c in s.init_containers],
        overhead=dict(s.overhead),
        node_selector=dict(s.node_selector),
        affinity=s.affinity,  # frozen
        tolerations=list(s.tolerations),  # items frozen
        topology_spread_constraints=list(s.topology_spread_constraints),
        host_network=s.host_network,
        restart_policy=s.restart_policy,
        termination_grace_period_seconds=s.termination_grace_period_seconds,
        volumes=[_copy_volume(v) for v in s.volumes],
        service_account_name=s.service_account_name,
        active_deadline_seconds=s.active_deadline_seconds,
        runtime_class_name=s.runtime_class_name,
    )


def _copy_pod_status(st: PodStatus) -> PodStatus:
    return PodStatus(
        phase=st.phase,
        conditions=[
            PodCondition(
                c.type, c.status, c.reason, c.message, c.last_transition_time
            )
            for c in st.conditions
        ],
        nominated_node_name=st.nominated_node_name,
        reason=st.reason,
        message=st.message,
        start_time=st.start_time,
        pod_ip=st.pod_ip,
        host_ip=st.host_ip,
        container_statuses=[
            ContainerStatus(cs.name, cs.ready, cs.restart_count, cs.state)
            for cs in st.container_statuses
        ],
    )


def compute_pod_resource_request(
    pod: Pod, non_zero: bool = False
) -> ResourceList:
    """Pod effective resource request.

    max(sum(containers), max(initContainers)) + overhead — the formula at
    reference pkg/scheduler/framework/plugins/noderesources/fit.go:99-116
    (computePodResourceRequest) and nodeinfo calculateResource
    (node_info.go:568). With non_zero=True, cpu/memory requests of 0 are
    replaced by the scoring defaults (100m / 200MB).
    """
    total = ResourceList()
    for c in pod.spec.containers:
        req = ResourceList.parse(c.requests)
        if non_zero:
            if req.get(CPU, 0) == 0:
                req[CPU] = DEFAULT_MILLI_CPU_REQUEST
            if req.get(MEMORY, 0) == 0:
                req[MEMORY] = DEFAULT_MEMORY_REQUEST
        total.add(req)
    init_max = ResourceList()
    for c in pod.spec.init_containers:
        req = ResourceList.parse(c.requests)
        init_max.set_max(req)
    total.set_max(init_max)
    if pod.spec.overhead:
        total.add(ResourceList.parse(pod.spec.overhead))
    return total


def pod_host_ports(pod: Pod) -> List[Tuple[str, str, int]]:
    """(hostIP, protocol, hostPort) triples a pod occupies (schedutil.GetContainerPorts)."""
    out = []
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                out.append((p.host_ip or "0.0.0.0", p.protocol or "TCP", p.host_port))
    return out


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    pod_cidr: str = ""
    provider_id: str = ""


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


NODE_READY = "Ready"


@dataclass
class NodeCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""
    last_heartbeat_time: float = field(default_factory=time.time)
    last_transition_time: float = field(default_factory=time.time)


@dataclass
class NodeStatus:
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)
    images: List[ContainerImage] = field(default_factory=list)
    addresses: List[Tuple[str, str]] = field(default_factory=list)
    node_info: Dict[str, str] = field(default_factory=dict)
    # kubelet volume manager reporting (reference VolumesInUse/
    # VolumesAttached): the safe-detach contract between node and the
    # attach-detach controller
    volumes_in_use: List[str] = field(default_factory=list)
    volumes_attached: List[str] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"

    def deep_copy(self) -> "Node":
        return Node(
            metadata=_copy_meta(self.metadata),
            spec=NodeSpec(
                unschedulable=self.spec.unschedulable,
                taints=list(self.spec.taints),  # items frozen
                pod_cidr=self.spec.pod_cidr,
                provider_id=self.spec.provider_id,
            ),
            status=NodeStatus(
                capacity=dict(self.status.capacity),
                allocatable=dict(self.status.allocatable),
                conditions=[
                    NodeCondition(
                        c.type,
                        c.status,
                        c.reason,
                        c.message,
                        c.last_heartbeat_time,
                        c.last_transition_time,
                    )
                    for c in self.status.conditions
                ],
                images=[
                    ContainerImage(list(im.names), im.size_bytes)
                    for im in self.status.images
                ],
                addresses=list(self.status.addresses),
                node_info=dict(self.status.node_info),
                volumes_in_use=list(self.status.volumes_in_use),
                volumes_attached=list(self.status.volumes_attached),
            ),
            kind=self.kind,
        )

    def __deepcopy__(self, memo) -> "Node":
        return self.deep_copy()

    def allocatable(self) -> ResourceList:
        src = self.status.allocatable or self.status.capacity
        rl = ResourceList.parse(src)
        rl.setdefault(PODS, 110)
        return rl


@dataclass
class Binding:
    """pods/{name}/binding subresource payload (DefaultBinder.Bind).

    Fields default empty so partial wire payloads decode; an empty pod_uid
    skips the uid check on bind."""

    pod_name: str = ""
    pod_namespace: str = ""
    pod_uid: str = ""
    target_node: str = ""
    kind: str = "Binding"


# ---------------------------------------------------------------------------
# Storage (subset needed for scheduling: volume binding / restrictions /
# zone / limits — reference staging/src/k8s.io/api/core/v1/types.go PV/PVC,
# storage/v1 StorageClass/CSINode)
# ---------------------------------------------------------------------------

CLAIM_PENDING = "Pending"
CLAIM_BOUND = "Bound"
CLAIM_LOST = "Lost"

BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    resources: Dict[str, Quantity] = field(default_factory=dict)  # requests
    storage_class_name: Optional[str] = None
    volume_name: str = ""  # bound PV name


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = CLAIM_PENDING
    # actual provisioned size; the expand controller reconciles
    # spec.resources["storage"] > status.capacity["storage"]
    capacity: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(
        default_factory=PersistentVolumeClaimSpec
    )
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )
    kind: str = "PersistentVolumeClaim"

    def deep_copy(self) -> "PersistentVolumeClaim":
        return copy.deepcopy(self)


@dataclass
class PersistentVolumeSpec:
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)
    storage_class_name: str = ""
    claim_ref: Optional[str] = None  # "namespace/name" of bound claim
    node_affinity: Optional[NodeSelector] = None  # volume node affinity
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    azure_disk: Optional[AzureDiskVolumeSource] = None
    cinder: Optional[CinderVolumeSource] = None
    iscsi: Optional[ISCSIVolumeSource] = None
    rbd: Optional[RBDVolumeSource] = None
    csi: Optional[CSIVolumeSource] = None


@dataclass
class PersistentVolumeStatus:
    phase: str = "Available"  # Available | Bound | Released | Failed


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(
        default_factory=PersistentVolumeStatus
    )
    kind: str = "PersistentVolume"

    def deep_copy(self) -> "PersistentVolume":
        return copy.deepcopy(self)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = BINDING_IMMEDIATE
    allow_volume_expansion: bool = False
    kind: str = "StorageClass"

    def deep_copy(self) -> "StorageClass":
        return copy.deepcopy(self)


@dataclass
class CSINodeDriver:
    name: str = ""
    node_id: str = ""
    allocatable_count: Optional[int] = None  # attachable volume limit


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)
    kind: str = "CSINode"

    def deep_copy(self) -> "CSINode":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Services & workload controllers (subset for SelectorSpread/ServiceAffinity)
# ---------------------------------------------------------------------------


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    phase: str = "Active"  # Active | Terminating
    kind: str = "Namespace"

    def deep_copy(self) -> "Namespace":
        return copy.deepcopy(self)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class ReplicaSetSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)  # matchLabels
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)
    kind: str = "ReplicaSet"

    def deep_copy(self) -> "ReplicaSet":
        return copy.deepcopy(self)


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    ports: List[Tuple[str, int]] = field(default_factory=list)
    type: str = "ClusterIP"  # ClusterIP | NodePort | LoadBalancer
    external_ips: List[str] = field(default_factory=list)  # LB-assigned


@dataclass
class LoadBalancerStatus:
    """v1.LoadBalancerStatus: provisioned LB ingress points (IPs)."""

    ingress: List[str] = field(default_factory=list)


@dataclass
class ServiceStatus:
    load_balancer: LoadBalancerStatus = field(
        default_factory=LoadBalancerStatus
    )


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)
    kind: str = "Service"

    def deep_copy(self) -> "Service":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Workload controllers: Deployment / Job / DaemonSet / StatefulSet
# (apps/v1 + batch/v1 subset; reference staging/src/k8s.io/api/apps/v1 and
# batch/v1 types.go — the fields the controllers in pkg/controller consume)
# ---------------------------------------------------------------------------

ROLLING_UPDATE = "RollingUpdate"
RECREATE = "Recreate"


@dataclass
class DeploymentStrategy:
    type: str = ROLLING_UPDATE
    max_surge: int = 1  # absolute counts (reference also allows percentages)
    max_unavailable: int = 0


@dataclass
class DeploymentSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)  # matchLabels
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    revision_history_limit: int = 10
    paused: bool = False


@dataclass
class DeploymentStatus:
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    unavailable_replicas: int = 0
    observed_generation: int = 0


@dataclass
class Deployment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)
    kind: str = "Deployment"

    def deep_copy(self) -> "Deployment":
        return copy.deepcopy(self)


@dataclass
class JobSpec:
    parallelism: int = 1
    completions: Optional[int] = None  # None => any single success completes
    backoff_limit: int = 6
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    active_deadline_seconds: Optional[int] = None
    ttl_seconds_after_finished: Optional[int] = None  # ttlafterfinished GC


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    conditions: List[PodCondition] = field(default_factory=list)  # Complete/Failed


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    kind: str = "Job"

    def deep_copy(self) -> "Job":
        return copy.deepcopy(self)


@dataclass
class DaemonSetSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DaemonSetStatus:
    current_number_scheduled: int = 0
    desired_number_scheduled: int = 0
    number_ready: int = 0
    number_misscheduled: int = 0
    observed_generation: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)
    kind: str = "DaemonSet"

    def deep_copy(self) -> "DaemonSet":
        return copy.deepcopy(self)


@dataclass
class StatefulSetSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    pod_management_policy: str = "OrderedReady"  # or Parallel


@dataclass
class StatefulSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    observed_generation: int = 0


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)
    kind: str = "StatefulSet"

    def deep_copy(self) -> "StatefulSet":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# PodDisruptionBudget (policy/v1beta1) — consumed by the disruption
# controller and the scheduler's preemption PDB accounting
# (reference pkg/controller/disruption/disruption.go,
# pkg/scheduler/core/generic_scheduler.go:940 selectVictimsOnNode)
# ---------------------------------------------------------------------------


@dataclass
class PodDisruptionBudgetSpec:
    # exactly one of min_available / max_unavailable set (absolute counts;
    # the reference also allows percentages — intentional simplification)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    selector: Dict[str, str] = field(default_factory=dict)  # matchLabels


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0
    observed_generation: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(
        default_factory=PodDisruptionBudgetStatus
    )
    kind: str = "PodDisruptionBudget"

    def deep_copy(self) -> "PodDisruptionBudget":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Endpoints (core/v1) — maintained by the endpoints controller, consumed by
# the proxy dataplane (reference pkg/controller/endpoint, pkg/proxy)
# ---------------------------------------------------------------------------


@dataclass
class EndpointAddress:
    ip: str = ""
    node_name: str = ""
    target_pod: str = ""  # namespace/name of backing pod


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[Tuple[str, int]] = field(default_factory=list)


@dataclass
class Endpoints:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: List[EndpointSubset] = field(default_factory=list)
    kind: str = "Endpoints"

    def deep_copy(self) -> "Endpoints":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# PriorityClass (scheduling.k8s.io/v1) — admission resolves
# priority_class_name -> spec.priority (reference
# plugin/pkg/admission/priority/admission.go)
# ---------------------------------------------------------------------------


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"  # or Never
    description: str = ""
    kind: str = "PriorityClass"

    def deep_copy(self) -> "PriorityClass":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# ConfigMap / Secret / ServiceAccount (core/v1) — reference
# staging/src/k8s.io/api/core/v1/types.go (ConfigMap, Secret, ServiceAccount)
# ---------------------------------------------------------------------------


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    binary_data: Dict[str, bytes] = field(default_factory=dict)
    immutable: bool = False
    kind: str = "ConfigMap"

    def deep_copy(self) -> "ConfigMap":
        return copy.deepcopy(self)


@dataclass
class Secret:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, bytes] = field(default_factory=dict)
    string_data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"
    immutable: bool = False
    kind: str = "Secret"

    def deep_copy(self) -> "Secret":
        return copy.deepcopy(self)


@dataclass
class ServiceAccount:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[str] = field(default_factory=list)  # token secret names
    automount_service_account_token: bool = True
    kind: str = "ServiceAccount"

    def deep_copy(self) -> "ServiceAccount":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# HorizontalPodAutoscaler (autoscaling/v1) — reference
# staging/src/k8s.io/api/autoscaling/v1/types.go; controller semantics at
# pkg/controller/podautoscaler/horizontal.go
# ---------------------------------------------------------------------------


@dataclass
class CrossVersionObjectReference:
    kind: str = ""
    name: str = ""


@dataclass
class HorizontalPodAutoscalerSpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference
    )
    min_replicas: int = 1
    max_replicas: int = 1
    target_cpu_utilization_percentage: Optional[int] = None


@dataclass
class HorizontalPodAutoscalerStatus:
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization_percentage: Optional[int] = None
    last_scale_time: Optional[float] = None
    observed_generation: int = 0


@dataclass
class HorizontalPodAutoscaler:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HorizontalPodAutoscalerSpec = field(
        default_factory=HorizontalPodAutoscalerSpec
    )
    status: HorizontalPodAutoscalerStatus = field(
        default_factory=HorizontalPodAutoscalerStatus
    )
    kind: str = "HorizontalPodAutoscaler"

    def deep_copy(self) -> "HorizontalPodAutoscaler":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# CronJob (batch/v1beta1) — reference staging/src/k8s.io/api/batch/v1beta1;
# controller semantics at pkg/controller/cronjob/cronjob_controller.go
# ---------------------------------------------------------------------------


@dataclass
class JobTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: "JobSpec" = field(default_factory=lambda: JobSpec())


@dataclass
class CronJobSpec:
    schedule: str = "* * * * *"  # 5-field cron
    suspend: bool = False
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    starting_deadline_seconds: Optional[int] = None
    job_template: JobTemplateSpec = field(default_factory=lambda: JobTemplateSpec())
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1


@dataclass
class CronJobStatus:
    active: List[str] = field(default_factory=list)  # job keys
    last_schedule_time: Optional[float] = None


@dataclass
class CronJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronJobSpec = field(default_factory=CronJobSpec)
    status: CronJobStatus = field(default_factory=CronJobStatus)
    kind: str = "CronJob"

    def deep_copy(self) -> "CronJob":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# ResourceQuota (core/v1) — reference staging/src/k8s.io/api/core/v1 +
# pkg/controller/resourcequota/resource_quota_controller.go
# ---------------------------------------------------------------------------


@dataclass
class ResourceQuotaSpec:
    hard: Dict[str, Quantity] = field(default_factory=dict)
    # quota scopes (reference ResourceQuotaScope): BestEffort,
    # NotBestEffort, Terminating, NotTerminating — a quota with scopes
    # tracks/limits only pods matching ALL of them
    scopes: List[str] = field(default_factory=list)


@dataclass
class PodSecurityPolicySpec:
    """Subset of policy/v1beta1 PSPSpec the validation gate acts on
    (reference plugin/pkg/admission/security/podsecuritypolicy)."""

    privileged: bool = False  # allow privileged containers
    host_network: bool = False  # allow hostNetwork pods
    run_as_user_rule: str = "RunAsAny"  # RunAsAny | MustRunAsNonRoot


@dataclass
class PodSecurityPolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSecurityPolicySpec = field(default_factory=PodSecurityPolicySpec)
    kind: str = "PodSecurityPolicy"

    def deep_copy(self) -> "PodSecurityPolicy":
        return copy.deepcopy(self)


@dataclass
class RuntimeClassScheduling:
    """node/v1 Scheduling: where pods of this class may run."""

    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)


@dataclass
class RuntimeClass:
    """node/v1 RuntimeClass (reference staging/src/k8s.io/api/node/v1):
    names a container runtime handler; overhead joins the pod's resource
    accounting and scheduling constrains placement — both merged into the
    pod by the RuntimeClass admission plugin."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    handler: str = ""
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    scheduling: Optional[RuntimeClassScheduling] = None
    kind: str = "RuntimeClass"

    def deep_copy(self) -> "RuntimeClass":
        return copy.deepcopy(self)


@dataclass
class ResourceQuotaStatus:
    hard: Dict[str, Quantity] = field(default_factory=dict)
    used: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)
    kind: str = "ResourceQuota"

    def deep_copy(self) -> "ResourceQuota":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# CustomResourceDefinition + Unstructured (apiextensions-apiserver
# equivalent) — reference staging/src/k8s.io/apiextensions-apiserver/pkg/
# apis/apiextensions/types.go; dynamic clients use unstructured objects
# (apimachinery/pkg/apis/meta/v1/unstructured).
# ---------------------------------------------------------------------------


@dataclass
class CustomResourceDefinitionNames:
    plural: str = ""
    singular: str = ""
    kind: str = ""
    list_kind: str = ""
    short_names: List[str] = field(default_factory=list)


@dataclass
class CustomResourceDefinitionSpec:
    group: str = ""
    names: CustomResourceDefinitionNames = field(
        default_factory=CustomResourceDefinitionNames
    )
    scope: str = "Namespaced"  # or Cluster
    versions: List[str] = field(default_factory=lambda: ["v1"])


@dataclass
class CustomResourceDefinitionStatus:
    accepted_names: CustomResourceDefinitionNames = field(
        default_factory=CustomResourceDefinitionNames
    )
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class CustomResourceDefinition:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CustomResourceDefinitionSpec = field(
        default_factory=CustomResourceDefinitionSpec
    )
    status: CustomResourceDefinitionStatus = field(
        default_factory=CustomResourceDefinitionStatus
    )
    kind: str = "CustomResourceDefinition"

    def deep_copy(self) -> "CustomResourceDefinition":
        return copy.deepcopy(self)


@dataclass
class Unstructured:
    """Schema-less object for custom resources: typed metadata (so the
    store/watch/WAL machinery works unchanged) + raw content for the rest."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    content: Dict[str, Any] = field(default_factory=dict)
    kind: str = ""
    api_version: str = "v1"

    def deep_copy(self) -> "Unstructured":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# APIService (kube-aggregator) — reference
# staging/src/k8s.io/kube-aggregator/pkg/apis/apiregistration/types.go:
# claims a (group, version) and names the backend serving it.
# ---------------------------------------------------------------------------


@dataclass
class APIServiceSpec:
    group: str = ""
    version: str = "v1"
    service_url: str = ""  # backend base URL ("" = served locally)
    priority: int = 100
    # TLS to the backend (kube-aggregator apiservice certs): base64 PEM
    # bundle the proxy verifies https backends against; skip flag mirrors
    # the reference's insecureSkipTLSVerify escape hatch
    ca_bundle: str = ""
    insecure_skip_tls_verify: bool = False


@dataclass
class APIService:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: APIServiceSpec = field(default_factory=APIServiceSpec)
    kind: str = "APIService"

    def deep_copy(self) -> "APIService":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# EndpointSlice (discovery.k8s.io/v1beta1) — reference
# staging/src/k8s.io/api/discovery/v1beta1/types.go; produced by
# pkg/controller/endpointslice with at most 100 endpoints per slice.
# ---------------------------------------------------------------------------


@dataclass
class Endpoint:
    addresses: List[str] = field(default_factory=list)
    ready: bool = True
    target_pod: str = ""  # namespace/name of backing pod
    node_name: str = ""


@dataclass
class EndpointSlice:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    address_type: str = "IPv4"
    endpoints: List[Endpoint] = field(default_factory=list)
    ports: List[Tuple[str, int]] = field(default_factory=list)
    kind: str = "EndpointSlice"

    def deep_copy(self) -> "EndpointSlice":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# VolumeAttachment (storage.k8s.io/v1) — reference
# staging/src/k8s.io/api/storage/v1/types.go; written by the attach-detach
# controller (pkg/controller/volume/attachdetach), consumed by CSI.
# ---------------------------------------------------------------------------


@dataclass
class VolumeAttachmentSpec:
    attacher: str = ""  # driver name
    node_name: str = ""
    pv_name: str = ""  # source.persistentVolumeName


@dataclass
class VolumeAttachmentStatus:
    attached: bool = False


@dataclass
class VolumeAttachment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: VolumeAttachmentSpec = field(default_factory=VolumeAttachmentSpec)
    status: VolumeAttachmentStatus = field(
        default_factory=VolumeAttachmentStatus
    )
    kind: str = "VolumeAttachment"

    def deep_copy(self) -> "VolumeAttachment":
        return copy.deepcopy(self)


@dataclass
class Eviction:
    """pods/{name}/eviction subresource payload (policy/v1beta1 Eviction;
    reference registry/core/pod/rest/eviction.go): a PDB-respecting delete."""

    pod_name: str = ""
    pod_namespace: str = ""
    kind: str = "Eviction"


# ---------------------------------------------------------------------------
# ReplicationController (core/v1 — the pre-apps ancestor of ReplicaSet) and
# CertificateSigningRequest (certificates.k8s.io/v1beta1)
# ---------------------------------------------------------------------------


@dataclass
class ReplicationController:
    """Same reconcile contract as ReplicaSet (the reference implements both
    with one shared controller core, pkg/controller/replication)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: "ReplicaSetSpec" = None  # shared spec shape
    status: "ReplicaSetStatus" = None
    kind: str = "ReplicationController"

    def __post_init__(self):
        if self.spec is None:
            self.spec = ReplicaSetSpec()
        if self.status is None:
            self.status = ReplicaSetStatus()

    def deep_copy(self) -> "ReplicationController":
        return copy.deepcopy(self)


@dataclass
class CertificateSigningRequestSpec:
    request: str = ""  # CSR payload (opaque in this build; no x509)
    username: str = ""
    groups: List[str] = field(default_factory=list)
    usages: List[str] = field(default_factory=list)
    signer_name: str = "kubernetes.io/kube-apiserver-client-kubelet"


@dataclass
class CertificateSigningRequestStatus:
    conditions: List[PodCondition] = field(default_factory=list)  # Approved/Denied
    certificate: str = ""  # issued credential


@dataclass
class CertificateSigningRequest:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CertificateSigningRequestSpec = field(
        default_factory=CertificateSigningRequestSpec
    )
    status: CertificateSigningRequestStatus = field(
        default_factory=CertificateSigningRequestStatus
    )
    kind: str = "CertificateSigningRequest"

    def deep_copy(self) -> "CertificateSigningRequest":
        return copy.deepcopy(self)


@dataclass
class LimitRangeItem:
    type: str = "Container"  # Container | Pod
    max: Dict[str, Quantity] = field(default_factory=dict)
    min: Dict[str, Quantity] = field(default_factory=dict)
    default: Dict[str, Quantity] = field(default_factory=dict)  # limits
    default_request: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class LimitRangeSpec:
    limits: List[LimitRangeItem] = field(default_factory=list)


@dataclass
class LimitRange:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)
    kind: str = "LimitRange"

    def deep_copy(self) -> "LimitRange":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# RBAC (staging/src/k8s.io/api/rbac/v1/types.go): ClusterRole carries
# PolicyRules and optionally an AggregationRule; the aggregation controller
# (pkg/controller/clusterroleaggregation) unions rules of selected roles.


@dataclass
class PolicyRule:
    verbs: List[str] = field(default_factory=list)  # "*" = all
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    api_groups: List[str] = field(default_factory=list)


@dataclass
class AggregationRule:
    cluster_role_selectors: List[LabelSelector] = field(default_factory=list)


@dataclass
class ClusterRole:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: List[PolicyRule] = field(default_factory=list)
    aggregation_rule: Optional[AggregationRule] = None
    kind: str = "ClusterRole"

    def deep_copy(self) -> "ClusterRole":
        return copy.deepcopy(self)


@dataclass
class RoleRef:
    kind: str = "ClusterRole"
    name: str = ""


@dataclass
class Subject:
    kind: str = "User"  # User | Group | ServiceAccount
    name: str = ""
    namespace: str = ""


# ---------------------------------------------------------------------------
# Networking (staging/src/k8s.io/api/networking/v1): served types whose
# enforcement lives out of tree (ingress controllers, CNI plugins) — type
# parity so workloads can declare them and controllers/GC can own them.


@dataclass
class IngressBackend:
    service_name: str = ""
    service_port: int = 0


@dataclass
class IngressPath:
    path: str = "/"
    path_type: str = "Prefix"  # Prefix | Exact
    backend: IngressBackend = field(default_factory=IngressBackend)


@dataclass
class IngressRule:
    host: str = ""
    paths: List[IngressPath] = field(default_factory=list)


@dataclass
class IngressSpec:
    ingress_class_name: Optional[str] = None
    default_backend: Optional[IngressBackend] = None
    rules: List[IngressRule] = field(default_factory=list)


@dataclass
class Ingress:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressSpec = field(default_factory=IngressSpec)
    kind: str = "Ingress"

    def deep_copy(self) -> "Ingress":
        return copy.deepcopy(self)


@dataclass
class IngressClassSpec:
    controller: str = ""  # e.g. "example.com/ingress-controller"


@dataclass
class IngressClass:
    """networking.k8s.io IngressClass (reference v1beta1, 1.18): names an
    ingress controller implementation; the cluster default is marked with
    the ingressclass.kubernetes.io/is-default-class annotation and
    stamped onto classless Ingresses by the DefaultIngressClass admission
    plugin."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressClassSpec = field(default_factory=IngressClassSpec)
    kind: str = "IngressClass"

    def deep_copy(self) -> "IngressClass":
        return copy.deepcopy(self)


@dataclass
class NetworkPolicyPeer:
    pod_selector: Optional[LabelSelector] = None
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class NetworkPolicyRule:
    ports: List[Tuple[str, int]] = field(default_factory=list)  # (proto, port)
    peers: List[NetworkPolicyPeer] = field(default_factory=list)


@dataclass
class NetworkPolicySpec:
    pod_selector: Optional[LabelSelector] = None  # None/empty = all pods
    policy_types: List[str] = field(default_factory=lambda: ["Ingress"])
    ingress: List[NetworkPolicyRule] = field(default_factory=list)
    egress: List[NetworkPolicyRule] = field(default_factory=list)


@dataclass
class NetworkPolicy:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NetworkPolicySpec = field(default_factory=NetworkPolicySpec)
    kind: str = "NetworkPolicy"

    def deep_copy(self) -> "NetworkPolicy":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Dynamic admission (staging/src/k8s.io/api/admissionregistration/v1):
# webhook configurations consumed by the apiserver's webhook admission.


@dataclass
class WebhookClientConfig:
    url: str = ""  # http(s)://host:port/path — service refs are not modeled


@dataclass
class RuleWithOperations:
    operations: List[str] = field(default_factory=lambda: ["*"])  # CREATE/UPDATE/DELETE/*
    resources: List[str] = field(default_factory=lambda: ["*"])


@dataclass
class Webhook:
    name: str = ""
    client_config: WebhookClientConfig = field(default_factory=WebhookClientConfig)
    rules: List[RuleWithOperations] = field(default_factory=list)
    failure_policy: str = "Fail"  # Fail | Ignore
    timeout_seconds: float = 10.0


@dataclass
class MutatingWebhookConfiguration:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: List[Webhook] = field(default_factory=list)
    kind: str = "MutatingWebhookConfiguration"

    def deep_copy(self) -> "MutatingWebhookConfiguration":
        return copy.deepcopy(self)


@dataclass
class ValidatingWebhookConfiguration:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: List[Webhook] = field(default_factory=list)
    kind: str = "ValidatingWebhookConfiguration"

    def deep_copy(self) -> "ValidatingWebhookConfiguration":
        return copy.deepcopy(self)


@dataclass
class ClusterRoleBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    role_ref: RoleRef = field(default_factory=RoleRef)
    subjects: List[Subject] = field(default_factory=list)
    kind: str = "ClusterRoleBinding"

    def deep_copy(self) -> "ClusterRoleBinding":
        return copy.deepcopy(self)
