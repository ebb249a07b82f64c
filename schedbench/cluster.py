"""A configuration file made into the API objects the program is given.

The node and pod shapes are scheduler_perf's (kubernetes v1.18
``test/integration/scheduler_perf``): nodes of 4 CPU, 32Gi and 110 pods
spread round-robin over the zones (``scheduler_test.go``), pods of the
pod template ``config/pod-default.yaml`` (100m CPU, 500Mi of memory).
The objects are built here, not by ``kubernetes_tpu_torch/perf/workloads.py``,
so that a change to the program cannot move the yardstick. Every number
comes from the configuration file; nothing here depends on a cell.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import List

from kubernetes_tpu_torch.api.objects import (
    Affinity,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodSpec,
)
from kubernetes_tpu_torch.api.selectors import LabelSelector


INIT_PREFIX = "init-"
NODE_PREFIX = "node-"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def node_name(i: int) -> str:
    return f"{NODE_PREFIX}{i}"


def zone_of(cfg: dict, i: int) -> str:
    return f"zone-{i % cfg['zones']}"


def make_nodes(cfg: dict) -> List[Node]:
    alloc = dict(cfg["node_allocatable"])
    return [
        Node(
            metadata=ObjectMeta(
                name=node_name(i),
                namespace="",
                labels={
                    cfg["zone_label"]: zone_of(cfg, i),
                    cfg["hostname_label"]: node_name(i),
                },
            ),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=dict(alloc)),
        )
        for i in range(cfg["num_nodes"])
    ]


def _pod(name: str, uid: str, labels: dict, requests: dict, affinity=None) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, uid=uid, labels=dict(labels)),
        spec=PodSpec(
            containers=[Container(requests=dict(requests))],
            affinity=affinity,
        ),
    )


def measured_affinity(cfg: dict):
    term = cfg.get("required_pod_affinity")
    if not term:
        return None
    sel = LabelSelector.make(match_labels=dict(term["match_labels"]))
    return Affinity(
        pod_affinity=PodAffinity(
            required=(
                PodAffinityTerm(label_selector=sel, topology_key=term["topology_key"]),
            )
        )
    )


def seed_tag(seed: int) -> str:
    """A short name prefix drawn from the seed: every seed names its pods
    apart, and the same seed names them alike."""
    return hashlib.sha256(str(int(seed)).encode()).hexdigest()[:8]


def init_pods(cfg: dict, seed: int) -> List[Pod]:
    tag = seed_tag(seed)
    return [
        _pod(f"{INIT_PREFIX}{i}", f"{tag}-init-{i}", cfg["init_pod_labels"], cfg["pod_requests"])
        for i in range(cfg["num_init_pods"])
    ]


class Names:
    """Pod and node names as integers and back, so that the bind stream
    keeps numbers, not strings: measured pod ``m-<tag>-<i>`` is i, init
    pod ``init-<i>`` is -1 - i, node ``node-<i>`` is i and no node -1.
    Any other name (another seed's pod, a node the benchmark did not
    make) gets an id of its own beyond these, so it still shows."""

    OTHER_POD = 1 << 40
    OTHER_NODE = -(1 << 30)

    def __init__(self, seed: int):
        self.tag = seed_tag(seed)
        self._measured = f"m-{self.tag}-"
        self._other_pods: dict = {}
        self._other_nodes: dict = {}

    def measured(self, i: int) -> str:
        return f"{self._measured}{i}"

    @staticmethod
    def _index(name: str, prefix: str) -> int:
        s = name[len(prefix):] if name.startswith(prefix) else ""
        return int(s) if s.isdigit() and str(int(s)) == s else -1

    def pod_id(self, name: str) -> int:
        i = self._index(name, self._measured)
        if 0 <= i < self.OTHER_POD:
            return i
        i = self._index(name, INIT_PREFIX)
        if i >= 0:
            return -1 - i
        return self._other_pods.setdefault(name, self.OTHER_POD + len(self._other_pods))

    def pod_name(self, pid: int) -> str:
        if 0 <= pid < self.OTHER_POD:
            return self.measured(pid)
        if pid < 0:
            return f"{INIT_PREFIX}{-1 - pid}"
        return next(n for n, i in self._other_pods.items() if i == pid)

    def node_id(self, name) -> int:
        if not name:
            return -1
        i = self._index(name, NODE_PREFIX)
        if 0 <= i < -self.OTHER_NODE:
            return i
        return self._other_nodes.setdefault(name, self.OTHER_NODE - len(self._other_nodes))

    def node_name(self, nid: int):
        if nid == -1:
            return None
        if nid >= 0:
            return node_name(nid)
        return next(n for n, i in self._other_nodes.items() if i == nid)


class PodPool:
    """The measured pods: one template, copied, each copy named
    ``m-<tag>-<i>`` in creation order, so the seed fixes every name and
    the order. ``take()`` makes the next one as the generator creates
    it: a pool made before the window would sit in the collector's
    oldest generation and shrink as it is used, so each full collection
    in the window would cost less than the one before."""

    def __init__(self, cfg: dict, seed: int):
        self.names = Names(seed)
        self._tpl = _pod(
            "", "", cfg["pod_labels"], cfg["pod_requests"], measured_affinity(cfg)
        )
        self._next = 0

    def take(self) -> Pod:
        i = self._next
        self._next += 1
        p = self._tpl.deep_copy()
        p.metadata.name = self.names.measured(i)
        p.metadata.uid = f"{self.names.tag}-{i}"
        return p


def cell_files(root: Path, bench: dict, workload: str):
    """(workload entry, configuration entry, configuration, traffic) of the
    cell named `workload`, each found by the name BENCHMARK.json gives."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[cell["config"]]
    cfg = load_json(root / centry["file"])
    traffic = load_json(root / "schedbench" / "traffic" / f"{cell['traffic']}.json")
    return cell, centry, cfg, traffic


def load_named(kind: str, name: str):
    """The module ``schedbench/<kind>/<name>.py``, loaded by its path: a
    per-name file (a metric's reader, a traffic loop) that a later cell
    adds without an edit to this one."""
    import importlib.util

    path = Path(__file__).with_name(kind) / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"schedbench_{kind}_" + "".join(ch if ch.isalnum() else "_" for ch in name), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
