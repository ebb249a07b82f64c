"""API object model: resources, labels/selectors, Pod/Node types.

The moral equivalent of the reference's staging/src/k8s.io/api +
apimachinery's label/selector machinery, reduced to the typed surface the
control plane actually consumes, with TPU-friendly plain-data objects
(dataclasses, no codegen).
"""

from .resources import (  # noqa: F401
    Quantity,
    parse_quantity,
    ResourceList,
    MILLI_CPU,
    MEMORY,
    EPHEMERAL_STORAGE,
    PODS,
    DEFAULT_MILLI_CPU_REQUEST,
    DEFAULT_MEMORY_REQUEST,
)
from .selectors import (  # noqa: F401
    Requirement,
    LabelSelector,
    labels_match_selector,
    selector_from_match_labels,
)
from .objects import (  # noqa: F401
    ObjectMeta,
    OwnerReference,
    Taint,
    Toleration,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSelector,
    PreferredSchedulingTerm,
    NodeAffinity,
    PodAffinityTerm,
    WeightedPodAffinityTerm,
    PodAffinity,
    PodAntiAffinity,
    Affinity,
    TopologySpreadConstraint,
    ContainerPort,
    Container,
    PodSpec,
    PodCondition,
    PodStatus,
    Pod,
    NodeSpec,
    ContainerImage,
    NodeCondition,
    NodeStatus,
    Node,
    Binding,
)
