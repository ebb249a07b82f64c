"""Resource quantities and resource lists.

Replaces the reference's apimachinery resource.Quantity
(staging/src/k8s.io/apimachinery/pkg/api/resource) with a minimal parser that
covers the forms the scheduler consumes, and the scheduler's internal
Resource accounting (reference pkg/scheduler/nodeinfo/node_info.go:143-153:
MilliCPU, Memory, EphemeralStorage, AllowedPodNumber, ScalarResources).

Everything is normalised at parse time into the units the device kernels use:
  cpu               -> integer millicores   (column MILLI_CPU)
  memory/storage    -> integer bytes        (columns MEMORY / EPHEMERAL_STORAGE)
  pods              -> integer count        (column PODS)
  extended/scalar   -> raw integer value    (per-name extended columns)
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Mapping, Union

# Canonical resource names (reference: v1.ResourceCPU etc.)
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

# Internal accounting column for cpu is millicores.
MILLI_CPU = "cpu"  # stored as millicores internally

# Reference defaults for the "non-zero" request used by scoring when a
# container specifies no request (pkg/scheduler/nodeinfo/node_info.go &
# priorities: DefaultMilliCPURequest=100, DefaultMemoryRequest=200MB).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": 10**-9,
    "u": 10**-6,
    "m": 10**-3,
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QTY_RE = re.compile(
    r"^(?P<num>[+-]?\d+(?:\.\d*)?|\.\d+)(?:[eE](?P<exp>[+-]?\d+))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?$"
)

Quantity = Union[int, float, str]


def parse_quantity(q: Quantity) -> float:
    """Parse a Kubernetes quantity string into a plain float of base units.

    "100m" -> 0.1, "1Gi" -> 1073741824, "2" -> 2.0, 500 -> 500.0.
    """
    if isinstance(q, (int, float)):
        return float(q)
    return _parse_quantity_str(q)


@lru_cache(maxsize=4096)
def _parse_quantity_str(q: str) -> float:
    # quantity strings repeat endlessly ("500m", "1Gi", ...) across pod
    # events — memoized because this sits under every resource computation
    s = q.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {q!r}")
    num = float(m.group("num"))
    if m.group("exp"):
        num *= 10 ** int(m.group("exp"))
    suffix = m.group("suffix") or ""
    if suffix in _BINARY_SUFFIX:
        return num * _BINARY_SUFFIX[suffix]
    return num * _DECIMAL_SUFFIX[suffix]


def cpu_to_millis(q: Quantity) -> int:
    """cpu quantity -> integer millicores (ceil, like resource.MilliValue)."""
    v = parse_quantity(q) * 1000.0
    iv = int(v)
    return iv if iv == v else iv + (1 if v > 0 else 0)


def to_int_value(q: Quantity) -> int:
    """Generic quantity -> integer base value (ceil)."""
    v = parse_quantity(q)
    iv = int(v)
    return iv if iv == v else iv + (1 if v > 0 else 0)


class ResourceList(dict):
    """A resource-name -> normalised-integer-amount mapping.

    cpu is stored in millicores; memory/ephemeral-storage in bytes; anything
    else in raw integer units. Mirrors the arithmetic the scheduler does on
    nodeinfo.Resource (Add/SetMaxResource, node_info.go:313,377).
    """

    @classmethod
    def parse(cls, raw: Mapping[str, Quantity] | None) -> "ResourceList":
        out = cls()
        if not raw:
            return out
        for name, q in raw.items():
            if name == CPU:
                out[CPU] = cpu_to_millis(q)
            else:
                out[name] = to_int_value(q)
        return out

    def add(self, other: Mapping[str, int]) -> "ResourceList":
        for k, v in other.items():
            self[k] = self.get(k, 0) + v
        return self

    def sub(self, other: Mapping[str, int]) -> "ResourceList":
        for k, v in other.items():
            self[k] = self.get(k, 0) - v
        return self

    def set_max(self, other: Mapping[str, int]) -> "ResourceList":
        """Element-wise max (init-container semantics, node_info.go:377)."""
        for k, v in other.items():
            self[k] = max(self.get(k, 0), v)
        return self

    def copy(self) -> "ResourceList":
        return ResourceList(self)


def is_extended_resource(name: str) -> bool:
    return name not in (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)
