"""Gym replay + outcome scoring (port): the measurement half of the tuner.

PyTorch port of ``kubernetes_tpu/tuner/scoring.py``. Replay rides the
seam the autoscaler's ``WhatIfSimulator`` uses (``autoscaler/planner.py``):
under the cache lock, encode the pod batch FIRST (vocab interning settles
capacities), then take a ``SnapshotEncoder.whatif_overlay([])`` copy of the
live snapshot (freshly allocated tensors that share no storage with any
generation, never installed, never handed to a lease) and run the
production serial kernel (``ops/lattice.make_schedule_batch``) over it
outside the lock, on the encoder's device and its default stream. Weights
are a kernel input: K candidates are K launches over one overlay.

The tie noise is an input too (the reference passes a PRNG key). A
``noise`` argument of ``replay_candidate`` / ``rng_key`` of ``replay_wave``
is one of:

* a ``[P, N]`` float32 tensor in [0, 1) on the overlay's device, used as is;
* a ``torch.Generator`` state (the uint8 host tensor of ``get_state()``):
  a Generator on the overlay's device set to it draws
  ``torch.rand((P, N))``, which is exactly the draw the Scheduler's default
  serial noise made right after that state was taken
  (``Scheduler._noise_key``), so a recorded serial wave replays exactly;
* a callable ``(P, N) -> [P, N] tensor`` (what the Scheduler records for
  an injected noise source that offers ``replay_key()``).

Scoring is host arithmetic over one host copy per pass (a ``.cpu()`` of
each of the seven columns in place of the reference's ``jax.device_get``):
placed fraction, stranded-capacity fragmentation, preemption pressure, and
$-per-hour / energy. It, the outcome record, the pad rule and the
placement mapping are the reference's, text for text.
"""


from __future__ import annotations

from dataclasses import dataclass
import contextlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.batch import encode_pod_batch
from ..ops.lattice import make_schedule_batch

# utility mix: placed fraction dominates (a vector that fails to place
# traffic is worse than any amount of cost polish), then consolidation,
# then the $-and-watts opt-ins
FRAG_WEIGHT = 0.15
COST_WEIGHT = 0.20
ENERGY_WEIGHT = 0.10


def fragmentation_score(
    free_frac: np.ndarray, used_any: np.ndarray, valid: np.ndarray
) -> float:
    """Stranded-capacity fragmentation in [0, 1]: free capacity sitting
    on PARTIALLY used nodes / total free capacity. A consolidating
    placement leaves whole nodes empty (gang-sized holes survive); a
    smearing one strands its slack. ONE definition shared by the gym's
    outcome scoring (score_assignment), the live-fleet gauge
    (Scheduler.fragmentation_score), and the descheduler's planning
    signal — inputs come from SnapshotEncoder.utilization_stats or the
    gym's overlay columns, both derived from the same masters."""
    valid = np.asarray(valid, bool)
    stranded_mask = np.asarray(used_any, bool) & valid
    total_free = float(free_frac[valid].sum())
    stranded = float(free_frac[stranded_mask].sum())
    return stranded / total_free if total_free > 0 else 0.0


@dataclass
class WaveOutcome:
    """Scored outcome of one (replayed or production) wave placement."""

    placed: int
    total: int
    fragmentation: float  # stranded free capacity fraction, [0, 1]
    preempt_pressure: int  # unplaced pods (they go on to preempt/queue)
    cost_norm: float  # mean chosen-node cost / fleet max, [0, 1]
    energy_norm: float  # mean chosen-node energy / fleet max, [0, 1]
    utility: float

    @property
    def placed_frac(self) -> float:
        return self.placed / self.total if self.total else 1.0


@dataclass
class OverlaySnapshot:
    """One overlay + encoded batch, shared by every candidate launch of
    a gym pass, plus the host-side columns scoring needs (fetched
    once)."""

    snap: Any  # DeviceSnapshot overlay copy (never donated)
    batch: Any  # device PodBatch
    pod_valid: np.ndarray  # [P] bool — encoded and not fallback
    req: np.ndarray  # [P, R] host copy
    row_names: List[Optional[str]]
    v_cap: int
    node_valid: np.ndarray  # [N] bool
    free0: np.ndarray  # [N, R] allocatable - requested (pre-placement)
    alloc: np.ndarray  # [N, R]
    cost_milli: np.ndarray  # [N]
    energy_milli: np.ndarray  # [N]
    accel_class: np.ndarray  # [N] interned class id, -1 unlabeled


def pad_pow2(n: int) -> int:
    """The serial path's pad rule (Scheduler._pad): replay must encode
    with the same pad so differential replays share compiled shapes with
    production."""
    p = 1
    while p < max(1, n):
        p *= 2
    return p


def build_overlay(cache, pods: Sequence[Any]) -> Optional[OverlaySnapshot]:
    """Encode ``pods`` and take an isolated overlay of the live snapshot.
    Caller does NOT hold the cache lock. None when the encoder can't
    host the overlay (no free capacity — the gym skips the pass)."""
    with cache.lock:
        enc = cache.encoder
        eb = encode_pod_batch(enc, list(pods), pad_to=pad_pow2(len(pods)))
        ov = enc.whatif_overlay([])
        if ov is None:
            return None
        snap, _rows = ov
        row_names = list(enc.row_names)
        v_cap = enc.cfg.v_cap
    # ONE host copy per pass, shared by every candidate's scoring
    requested, allocatable, node_valid, cost, energy, accel, req = (
        t.cpu().numpy()
        for t in (
            snap.requested,
            snap.allocatable,
            snap.valid,
            snap.cost_milli,
            snap.energy_milli,
            snap.accel_class,
            eb.batch.req,
        )
    )
    req = np.asarray(req)
    pod_valid = np.zeros(req.shape[0], bool)
    pod_valid[: len(pods)] = True
    pod_valid[: len(pods)] &= ~np.asarray(eb.fallback[: len(pods)], bool)
    return OverlaySnapshot(
        snap=snap,
        batch=eb.batch,
        pod_valid=pod_valid,
        req=req,
        row_names=row_names,
        v_cap=v_cap,
        node_valid=np.asarray(node_valid, bool),
        free0=np.asarray(allocatable, np.int64)
        - np.asarray(requested, np.int64),
        alloc=np.asarray(allocatable, np.int64),
        cost_milli=np.asarray(cost, np.int64),
        energy_milli=np.asarray(energy, np.int64),
        accel_class=np.asarray(accel, np.int64),
    )


def replay_candidate(
    ov: OverlaySnapshot, weights: np.ndarray, noise, hard_weight: float
) -> np.ndarray:
    """One candidate launch over the shared overlay: returns host [P]
    chosen rows (-1 unplaced). ``noise`` is the tie noise (a tensor, a
    Generator state or a redraw callable, see the module docstring); every
    arm of a gym pass gets the same one. The kernel only reads the
    overlay, so the pass needs no lease; it runs on the overlay device's
    default stream, after the overlay's copies."""
    snap = ov.snap
    dev = snap.valid.device
    stream = (
        torch.cuda.stream(torch.cuda.default_stream(dev))
        if dev.type == "cuda"
        else contextlib.nullcontext()
    )
    with stream:
        kern = make_schedule_batch(ov.v_cap, hard_weight)
        p, n = int(ov.batch.valid.shape[0]), int(snap.valid.shape[0])
        res = kern(
            snap,
            ov.batch,
            np.asarray(weights, np.float32),
            tie_noise(noise, p, n, dev),
        )
        return res.chosen.cpu().numpy()


def tie_noise(noise, p: int, n: int, device) -> torch.Tensor:
    """The [p, n] tie-noise tensor a noise argument stands for, on
    ``device``."""
    if callable(noise):
        noise = noise(p, n)
    elif isinstance(noise, torch.Tensor) and noise.dtype == torch.uint8:
        gen = torch.Generator(device=device)
        gen.set_state(noise)
        noise = torch.rand(
            (p, n), generator=gen, device=device, dtype=torch.float32
        )
    if not isinstance(noise, torch.Tensor):
        raise TypeError(f"no tie noise from {type(noise).__name__}")
    return noise.to(device)


def rows_for_placements(
    ov: OverlaySnapshot, placements: Sequence[str]
) -> np.ndarray:
    """Production placements (node names, "" unplaced) → [P] rows on the
    overlay's row table, -1 where unplaced/unknown (a node that left the
    cluster since the wave scores as unplaced — honest, it no longer
    absorbs anything)."""
    index = {n: r for r, n in enumerate(ov.row_names) if n is not None}
    rows = np.full(ov.req.shape[0], -1, np.int64)
    for i, node in enumerate(placements[: ov.req.shape[0]]):
        if node:
            rows[i] = index.get(node, -1)
    return rows


def score_assignment(ov: OverlaySnapshot, chosen: np.ndarray) -> WaveOutcome:
    """Score an assignment (replayed or production) against the shared
    overlay columns. Pure host arithmetic — no device work."""
    chosen = np.asarray(chosen, np.int64)
    valid = ov.pod_valid.copy()
    total = int(valid.sum())
    n = ov.free0.shape[0]
    placed_mask = valid & (chosen >= 0) & (chosen < n)
    placed = int(placed_mask.sum())

    free = ov.free0.copy()
    if placed:
        np.subtract.at(
            free, chosen[placed_mask], ov.req[placed_mask].astype(np.int64)
        )
    # stranded-capacity fragmentation through the SHARED definition
    # (fragmentation_score above — the descheduler and the live gauge
    # consume the same arithmetic)
    nv = ov.node_valid
    alloc = np.maximum(ov.alloc, 1)
    used_any = (free < ov.alloc).any(axis=1) & nv
    free_frac = np.clip(free / alloc, 0.0, 1.0).mean(axis=1)
    fragmentation = fragmentation_score(free_frac, used_any, nv)

    cost_norm = energy_norm = 0.0
    if placed:
        max_cost = float(ov.cost_milli[nv].max(initial=0))
        max_energy = float(ov.energy_milli[nv].max(initial=0))
        rows = chosen[placed_mask]
        if max_cost > 0:
            cost_norm = float(ov.cost_milli[rows].mean()) / max_cost
        if max_energy > 0:
            energy_norm = float(ov.energy_milli[rows].mean()) / max_energy

    placed_frac = placed / total if total else 1.0
    utility = (
        placed_frac
        - FRAG_WEIGHT * fragmentation
        - COST_WEIGHT * cost_norm
        - ENERGY_WEIGHT * energy_norm
    )
    return WaveOutcome(
        placed=placed,
        total=total,
        fragmentation=fragmentation,
        preempt_pressure=total - placed,
        cost_norm=cost_norm,
        energy_norm=energy_norm,
        utility=float(utility),
    )


def divergence(
    ov: OverlaySnapshot, chosen: np.ndarray, prod_rows: np.ndarray
) -> float:
    """Fraction of (valid) pods the hypothetical assignment places on a
    DIFFERENT node than production did — the shadow-diff signal."""
    valid = ov.pod_valid
    total = int(valid.sum())
    if not total:
        return 0.0
    diff = (np.asarray(chosen, np.int64) != np.asarray(prod_rows, np.int64))
    return float((diff & valid).sum()) / total


def replay_wave(
    cache,
    pods: Sequence[Any],
    weights: np.ndarray,
    rng_key,
    hard_weight: float = 1.0,
) -> Optional[Tuple[List[str], WaveOutcome]]:
    """Single-wave replay convenience (the differential-corpus seam):
    encode + overlay + one candidate launch, returning pod-aligned node
    names ("" unplaced) and the scored outcome."""
    ov = build_overlay(cache, pods)
    if ov is None:
        return None
    chosen = replay_candidate(ov, weights, rng_key, hard_weight)
    names = []
    for i in range(len(pods)):
        row = int(chosen[i])
        name = ""
        if ov.pod_valid[i] and 0 <= row < len(ov.row_names):
            name = ov.row_names[row] or ""
        names.append(name)
    return names, score_assignment(ov, chosen)
