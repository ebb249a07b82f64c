"""Scale-up / scale-down planning as batched kernel what-if evaluation
(PyTorch port).

Port of ``kubernetes_tpu/autoscaler/planner.py``. ``WhatIfSimulator`` is
the port proper: the what-if pass is the port's serial lattice
(``ops/lattice.make_schedule_batch``, eager torch on the encoder's
device) over ``SnapshotEncoder.whatif_overlay``. The reference's
``jax.random.PRNGKey(7)`` is a ``torch.Generator`` on the encoder's
device seeded 7, and ``noise`` lets a caller supply the tie noise
instead, called as ``noise(P, N)`` for a ``[P, N]`` float32 tensor in
[0, 1) (the reference's per-pass ``uniform(split(sub, P)[i], (N,))``;
the Scheduler's ``serial_noise`` has the same form). The chosen rows
come back with one ``.cpu()`` after the pass. A pass that fails on the
device raises; it is never rerun on the CPU. Everything else here —
``pack_weights``, ``VIRTUAL_BIAS_TAINT``, ``SimResult``, ``ScaleUpPlan``,
``plan_scale_up``, ``DrainVerdict``, ``simulate_drain_set`` and
``simulate_drain`` — is copied from the reference.

The reference's notes follow.

Upstream's cluster-autoscaler re-implements the scheduler's filter plugins
to simulate placements (simulator/ in the CA repo — a second copy of the
predicates that must be kept in lockstep by hand). Here the simulation IS
the production lattice kernel (ops/lattice.make_schedule_batch) run against
a what-if overlay of the HBM snapshot (ops/encoding.whatif_overlay):

* **Scale-up**: all pending pods are batch-evaluated in ONE kernel pass
  against real rows + K virtual rows per candidate shape (the NodeGroup
  catalog). The kernel's serial scan carry is the bin-packer: each placed
  pod's occupancy is visible to the next pod's decision, and a
  MostAllocated-weighted score greedily fills the fewest virtual nodes.
  Only virtual rows the kernel actually chose are provisioned.

* **Scale-down**: an underutilized node is drained only if a what-if pass
  with that node's row masked invalid proves EVERY resident pod re-places
  somewhere feasible (the zero-eviction guarantee: a failed simulation
  blocks the drain, it never "tries anyway").

Pods whose spec overflows the static device encoding (eb.fallback) are
bin-packed host-side with the scheduler's own filter plugins (the
`host_filter` callable wraps framework filters — still no duplicated
plugin logic).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import objects as v1
from ..ops.batch import encode_pod_batch
from ..ops.lattice import (
    NUM_SCORE_COMPONENTS,
    SC_COST,
    SC_MOST_ALLOC,
    SC_TAINT,
    make_schedule_batch,
)
from ..scheduler.cache.nodeinfo import NodeInfo
from ..utils.metrics import metrics
from .nodegroups import NodeGroup, NodeGroupCatalog

logger = logging.getLogger("kubernetes_tpu.autoscaler.planner")

HIST_SIMULATION = "autoscaler_simulation_duration_seconds"
COUNTER_SIMULATIONS = "autoscaler_simulation_passes_total"


def pack_weights(cost_aware: bool = False) -> np.ndarray:
    """Score weights for what-if passes. Feasibility is entirely the
    kernel's filter mask; the score only has to (a) PACK — MostAllocated
    funnels successive pods onto the fullest feasible node, so the scan
    carry greedily fills the fewest new nodes — and (b) prefer REAL rows:
    virtual rows carry a simulation-only PreferNoSchedule taint
    (VIRTUAL_BIAS_TAINT), and the dominant TaintToleration weight makes an
    existing feasible node always beat opening a fresh virtual one.

    cost_aware adds (c): CHEAPEST-feasible-shape packing — the cost
    column (normalized-inverted over the feasible set) sits between the
    real-row bias and the pack score, so among feasible virtual shapes
    the cheaper one wins and MostAllocated only breaks cost ties. With an
    unlabeled catalog the cost component is constant (inert), so
    cost-aware stays safe to leave on."""
    w = np.zeros(NUM_SCORE_COMPONENTS, np.float32)
    w[SC_MOST_ALLOC] = 1.0
    w[SC_TAINT] = 1000.0
    if cost_aware:
        w[SC_COST] = 10.0
    return w


# stamped on virtual rows INSIDE the simulation only (never on the
# provisioned node): PreferNoSchedule doesn't gate feasibility, but its
# intolerable-prefer count feeds the TaintToleration score, which is how
# "don't open a new node for a pod an existing node can hold" is expressed
# through the production kernel instead of a hand-rolled post-filter
VIRTUAL_BIAS_TAINT = v1.Taint(
    "autoscaler.kubernetes-tpu.io/virtual", "", v1.TAINT_PREFER_NO_SCHEDULE
)


@dataclass
class SimResult:
    """One kernel what-if pass, decoded."""

    chosen: np.ndarray  # [P] row index or -1 (row-aligned with pods)
    fallback: np.ndarray  # [P] bool — pod overflowed the static encoding
    virtual_rows: Dict[int, str]  # row -> virtual node name


@dataclass
class ScaleUpPlan:
    """Which virtual nodes the kernel actually used, per group."""

    nodes: Dict[str, List[str]] = field(default_factory=dict)  # group -> names
    placed: int = 0  # pods the simulation placed (real or virtual rows)
    unplaced: int = 0  # pods no shape in the catalog could hold
    truncated: int = 0  # pending pods past max_pods_per_pass (not simulated)
    capped: int = 0  # kernel-chosen nodes dropped by the per-cycle cap
    skipped: str = ""  # non-empty: why no simulation ran

    @property
    def total_nodes(self) -> int:
        return sum(len(v) for v in self.nodes.values())


class WhatIfSimulator:
    """Runs the production serial lattice against snapshot overlays.

    Owns nothing but its tie-noise source: state (encoder, masters,
    locks) stays in the scheduler cache, and every pass encodes under
    `cache.lock` exactly like the serial device path. noise: None draws
    the tie noise from a ``torch.Generator`` on the encoder's device
    seeded 7; else ``noise(P, N)`` returns the ``[P, N]`` float32 noise
    in [0, 1) for one pass (tests inject the reference's)."""

    # the reference's three padded-batch buckets (each an XLA compile
    # there): the serial scan's cost scales with the PAD, not the live
    # pod count, so the buckets also bound a pass's time here
    PAD_BUCKETS = (64, 256)

    def __init__(self, cache: "SchedulerCache", hard_pod_affinity_weight: float = 1.0,
                 max_pods_per_pass: int = 1024, cost_aware: bool = True,
                 noise: Optional[Callable[[int, int], torch.Tensor]] = None):
        self.cache = cache
        self.hard_w = hard_pod_affinity_weight
        self.max_pods = max_pods_per_pass
        self.noise = noise
        self._rng = torch.Generator(device=cache.encoder.device)
        self._rng.manual_seed(7)
        # cost_aware: cheapest-feasible-shape packing through the cost
        # column (inert on unlabeled fleets); False = pure MostAllocated
        self._weights = pack_weights(cost_aware=cost_aware)

    def _pad(self, n: int) -> int:
        for b in self.PAD_BUCKETS:
            if n <= b < self.max_pods:
                return b
        return self.max_pods

    def simulate(
        self,
        pods: List[v1.Pod],
        virtual_nodes: List[v1.Node],
        mask_node: Optional[str] = None,
        kind: str = "scale_up",
        mask_nodes: Optional[List[str]] = None,
    ) -> Optional[SimResult]:
        """One what-if pass: pods × (real + virtual − masked) rows through
        the serial lattice. None when the overlay has no room or a masked
        node is unknown. mask_nodes masks SEVERAL rows at once (the
        descheduler's evict-set simulation); mask_node is the single-node
        spelling the scale-down path uses."""
        pods = pods[: self.max_pods]
        if virtual_nodes:
            biased = []
            for n in virtual_nodes:
                c = n.deep_copy()
                c.spec.taints = list(c.spec.taints) + [VIRTUAL_BIAS_TAINT]
                biased.append(c)
            virtual_nodes = biased
        masked_names = list(mask_nodes or [])
        if mask_node is not None:
            masked_names.append(mask_node)
        t0 = time.monotonic()
        with self.cache.lock:
            enc = self.cache.encoder
            mask_rows: List[int] = []
            for mn in masked_names:
                r = enc.row_of(mn)
                if r < 0:
                    return None
                mask_rows.append(r)
            # encode FIRST: predicate/eterm interning can grow capacities,
            # which must settle before the overlay snapshot is built
            eb = encode_pod_batch(enc, pods, pad_to=self._pad(len(pods)))
            ov = enc.whatif_overlay(virtual_nodes, mask_rows)
            if ov is None:
                return None
            snap, vrows = ov
            v_cap = enc.cfg.v_cap
        virtual_map = {
            row: node.metadata.name
            for node, row in zip(virtual_nodes, vrows)
        }
        # the overlay shares no storage with any generation, and the
        # serial kernel only reads its snapshot, so the pass needs no
        # lease: it may overlap wave launches and audits freely. It runs
        # on the default stream, after the overlay's copies.
        dev = snap.valid.device
        stream = (
            torch.cuda.stream(torch.cuda.default_stream(dev))
            if dev.type == "cuda"
            else contextlib.nullcontext()
        )
        with stream:
            kern = make_schedule_batch(v_cap, self.hard_w)
            p, n = int(eb.batch.valid.shape[0]), int(snap.valid.shape[0])
            if self.noise is not None:
                noise = self.noise(p, n)
            else:
                noise = torch.rand(
                    (p, n), generator=self._rng, device=dev,
                    dtype=torch.float32,
                )
            res = kern(snap, eb.batch, self._weights, noise)
            chosen = res.chosen.cpu().numpy()
        metrics.inc(COUNTER_SIMULATIONS, {"kind": kind})
        metrics.observe(HIST_SIMULATION, time.monotonic() - t0)
        return SimResult(
            chosen=chosen[: len(pods)],
            fallback=np.asarray(eb.fallback)[: len(pods)],
            virtual_rows=virtual_map,
        )


def plan_scale_up(
    sim: WhatIfSimulator,
    catalog: NodeGroupCatalog,
    pending: List[v1.Pod],
    sizes: Dict[str, int],
    live_names: set,
    max_provision_per_cycle: int = 16,
    host_filter: Optional[Callable[[v1.Pod, NodeInfo], bool]] = None,
) -> ScaleUpPlan:
    """One scale-up planning pass: K virtual rows per group with headroom,
    one kernel pass over all pending pods, provision exactly the virtual
    rows the kernel chose."""
    plan = ScaleUpPlan()
    if not pending:
        plan.skipped = "no pending pods"
        return plan
    virtual_nodes: List[v1.Node] = []
    slot_group: Dict[str, NodeGroup] = {}
    taken = set(live_names)
    for g in catalog.groups:
        headroom = max(0, g.max_size - sizes.get(g.name, 0))
        k = min(headroom, max_provision_per_cycle, len(pending))
        for i in range(k):
            # STABLE slot names, reused every pass: the virtual hostname
            # pseudo-label is interned into the live vocab by the overlay
            # encode, and a fresh name per candidate per pass would leak
            # vocab entries until v_cap grows — which recompiles BOTH the
            # simulator and the production kernel (their cache keys embed
            # v_cap). Real (unique) names are minted below only for slots
            # the kernel actually chose.
            name = f"whatif.{g.name}.{i}"
            virtual_nodes.append(g.make_node(name))
            slot_group[name] = g
    if not virtual_nodes:
        plan.skipped = "every group at max_size"
        return plan
    res = sim.simulate(pending, virtual_nodes, kind="scale_up")
    if res is None:
        plan.skipped = "no snapshot capacity for virtual rows"
        return plan
    plan.truncated = max(0, len(pending) - len(res.chosen))
    used: Dict[str, List[str]] = {}  # group -> chosen slot names
    fallback_pods: List[v1.Pod] = []
    for i, pod in enumerate(pending[: len(res.chosen)]):
        if res.fallback[i]:
            fallback_pods.append(pod)
            continue
        row = int(res.chosen[i])
        if row < 0:
            plan.unplaced += 1
            continue
        plan.placed += 1
        vname = res.virtual_rows.get(row)
        if vname is not None:
            used.setdefault(slot_group[vname].name, [])
            if vname not in used[slot_group[vname].name]:
                used[slot_group[vname].name].append(vname)
    # pods past the static encoding: host-side first-fit with the
    # scheduler's OWN filter plugins (host_filter), onto fresh bins
    bins: List[Tuple[NodeGroup, str, NodeInfo]] = []
    if fallback_pods and host_filter is not None:
        for pod in fallback_pods:
            placed = False
            for _g, _name, ni in bins:
                if host_filter(pod, ni):
                    moved = pod.deep_copy()
                    moved.spec.node_name = ni.node.metadata.name
                    ni.add_pod(moved)
                    placed = True
                    break
            if not placed:
                for g in catalog.groups:
                    planned = len(used.get(g.name, ()))
                    opened = sum(1 for b in bins if b[0] is g)
                    if (
                        sizes.get(g.name, 0) + planned + opened
                        >= g.max_size
                    ):
                        continue
                    name = g.next_name(taken)
                    ni = NodeInfo(g.make_node(name))
                    if host_filter(pod, ni):
                        taken.add(name)
                        moved = pod.deep_copy()
                        moved.spec.node_name = name
                        ni.add_pod(moved)
                        bins.append((g, name, ni))
                        placed = True
                        break
            if placed:
                plan.placed += 1
            else:
                plan.unplaced += 1
    elif fallback_pods:
        plan.unplaced += len(fallback_pods)
    # mint REAL (unique) node names for exactly the slots the kernel used
    # (plus the fallback host bins, which already carry real names), then
    # enforce the cycle-global provisioning cap: per-group K bounds the
    # overlay width, but a mixed-shape burst could otherwise provision
    # groups×K nodes in one pass
    nodes: Dict[str, List[str]] = {}
    for gname, slots in used.items():
        g = catalog.group(gname)
        nodes[gname] = [g.next_name(taken) for _ in slots]
        taken.update(nodes[gname])
    for g, name, _ni in bins:
        nodes.setdefault(g.name, []).append(name)
    total = 0
    for gname in list(nodes):
        keep: List[str] = []
        for n in nodes[gname]:
            if total < max_provision_per_cycle:
                keep.append(n)
                total += 1
            else:
                plan.capped += 1
        if keep:
            nodes[gname] = keep
        else:
            del nodes[gname]
    plan.nodes = nodes
    return plan


@dataclass
class DrainVerdict:
    ok: bool
    reason: str = ""
    replaced: int = 0  # resident pods the simulation re-placed


def simulate_drain_set(
    sim: WhatIfSimulator,
    node_names: List[str],
    resident: List[v1.Pod],
    kind: str = "scale_down",
) -> DrainVerdict:
    """Drain-set what-if: would every resident pod of the WHOLE set
    re-place with all of those rows masked out in one overlay? DaemonSet-
    owned pods are excluded (they die with their node by design). Any pod
    the kernel cannot represent OR cannot re-place fails the verdict —
    the caller must then NOT drain. The single-node scale-down path
    (simulate_drain) and the descheduler's multi-node consolidation plans
    share this exact verdict, so "is this eviction safe" has one answer."""
    movable = []
    for p in resident:
        if any(r.kind == "DaemonSet" for r in p.metadata.owner_references):
            continue
        # simulate the pod's RECREATION, not its current incarnation: the
        # bound copy carries spec.node_name, which would pin the kernel's
        # NodeName filter to exactly the row being masked out
        clone = p.deep_copy()
        clone.spec.node_name = ""
        movable.append(clone)
    if not movable:
        return DrainVerdict(ok=True, reason="no resident pods")
    if len(movable) > sim.max_pods:
        # simulate() truncates to max_pods_per_pass — a verdict that never
        # evaluated the tail pods must not authorize their eviction
        return DrainVerdict(
            ok=False,
            reason=(
                f"{len(movable)} resident pods exceed the simulation "
                f"width ({sim.max_pods})"
            ),
        )
    res = sim.simulate(movable, [], mask_nodes=list(node_names), kind=kind)
    if res is None:
        return DrainVerdict(ok=False, reason="node unknown to the snapshot")
    if bool(res.fallback.any()):
        # a pod outside the static encoding can't be what-if'd on device;
        # blocking is the conservative (zero-eviction) answer
        return DrainVerdict(
            ok=False, reason="resident pod overflows the device encoding"
        )
    unplaced = int((res.chosen < 0).sum())
    if unplaced:
        return DrainVerdict(
            ok=False,
            reason=f"{unplaced}/{len(movable)} resident pods do not re-place",
            replaced=len(movable) - unplaced,
        )
    return DrainVerdict(ok=True, replaced=len(movable))


def simulate_drain(
    sim: WhatIfSimulator,
    node_name: str,
    resident: List[v1.Pod],
) -> DrainVerdict:
    """Scale-down what-if for ONE node (the autoscaler's spelling of the
    shared drain-set verdict)."""
    return simulate_drain_set(sim, [node_name], resident)
