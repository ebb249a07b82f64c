"""Candidate weight-vector generators for the policy gym.

Three families, per the tentpole spec:

* **TOPSIS/entropy-derived** (arxiv 2506.04902): entropy weighting over
  a node-level decision matrix built from the snapshot columns. A
  criterion whose values DISPERSE across the fleet carries information
  (heterogeneous cost → the cost criterion can discriminate placements)
  and earns weight; a flat criterion earns none. Deterministic — same
  fleet, same candidate.
* **Gavel-style throughput-normalized heterogeneity weights** (arxiv
  2008.09213): the PR-15 ``accel_class``/``cost_milli``/``energy_milli``
  columns are exactly Gavel's inputs — cost and energy are normalized by
  the accelerator-class throughput proxy, so "cheapest" means cheapest
  per unit of delivered throughput, not per node-hour. Inert (returns
  nothing) on an unlabeled fleet.
* **Local perturbation of the incumbent**: seeded lognormal jitter —
  the hill-climbing arm that refines whatever already won.

Every generator returns finite float32 vectors; the promotion gate
re-validates through ``weights_for_policy`` anyway (defense in depth —
a poisoned injected candidate must die at the gate, not in a kernel).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops.lattice import (
    DEFAULT_WEIGHTS,
    NUM_SCORE_COMPONENTS,
    SC_BALANCED,
    SC_COST,
    SC_ENERGY,
    SC_LEAST_ALLOC,
    SC_MOST_ALLOC,
    WEIGHT_PROFILES,
)

# perturbation jitter: multiplicative lognormal, sigma per component
PERTURB_SIGMA = 0.35


def perturbation_candidates(
    incumbent: np.ndarray, rng: np.random.Generator, k: int = 4
) -> List[np.ndarray]:
    """k seeded local perturbations of the incumbent (multiplicative, so
    zero components stay zero — a perturbation explores the incumbent's
    POLICY neighborhood, it doesn't resurrect opt-in components the
    incumbent disabled; the TOPSIS/Gavel arms own those jumps)."""
    base = np.asarray(incumbent, np.float32)
    out = []
    for _ in range(max(0, k)):
        jitter = rng.lognormal(0.0, PERTURB_SIGMA, NUM_SCORE_COMPONENTS)
        out.append((base * jitter).astype(np.float32))
    return out


def _entropy_weights(matrix: np.ndarray) -> np.ndarray:
    """Entropy-method criteria weights over an [m alternatives, n
    criteria] decision matrix (the TOPSIS pipeline's objective-weighting
    stage): w_j ∝ 1 - e_j where e_j is the normalized Shannon entropy of
    criterion j's value distribution across alternatives."""
    m = matrix.shape[0]
    if m < 2:
        return np.full(matrix.shape[1], 1.0 / matrix.shape[1], np.float64)
    col = matrix - matrix.min(axis=0, keepdims=True)
    col_sum = col.sum(axis=0, keepdims=True)
    p = np.where(col_sum > 0, col / np.maximum(col_sum, 1e-12), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        plogp = np.where(p > 0, p * np.log(p), 0.0)
    e = -plogp.sum(axis=0) / np.log(m)
    d = np.clip(1.0 - e, 0.0, None)
    # a criterion that never varies (col_sum 0) carries no information
    d = np.where(col_sum.ravel() > 0, d, 0.0)
    total = d.sum()
    if total <= 0:
        return np.full(matrix.shape[1], 1.0 / matrix.shape[1], np.float64)
    return d / total


def topsis_candidates(
    requested: np.ndarray,
    allocatable: np.ndarray,
    valid: np.ndarray,
    cost_milli: np.ndarray,
    energy_milli: np.ndarray,
) -> List[np.ndarray]:
    """One entropy-weighted candidate from the live fleet's dispersion
    structure. Criteria (node-level): free fraction (LeastAllocated's
    signal), used fraction (MostAllocated's), resource imbalance
    (Balanced's), cost, energy. The resulting criteria weights land on
    the matching score components over a default base — the rest of the
    vector keeps reference semantics (affinity/taints/spread are
    correctness-adjacent, not up for entropy deletion)."""
    mask = np.asarray(valid, bool)
    if mask.sum() < 2:
        return []
    alloc = np.maximum(np.asarray(allocatable, np.float64)[mask], 1.0)
    used = np.asarray(requested, np.float64)[mask] / alloc
    used = np.clip(used, 0.0, 1.0)
    free_frac = (1.0 - used).mean(axis=1)
    used_frac = used.mean(axis=1)
    imbalance = used.std(axis=1)
    cost = np.asarray(cost_milli, np.float64)[mask]
    energy = np.asarray(energy_milli, np.float64)[mask]
    matrix = np.stack([free_frac, used_frac, imbalance, cost, energy], axis=1)
    w = _entropy_weights(matrix)
    cand = DEFAULT_WEIGHTS.copy()
    # scale into the profile weight range (built-ins use O(1)-O(100))
    scale = 10.0 / max(w.max(), 1e-9)
    cand[SC_LEAST_ALLOC] = w[0] * scale
    cand[SC_MOST_ALLOC] = w[1] * scale
    cand[SC_BALANCED] = max(float(cand[SC_BALANCED]), w[2] * scale)
    cand[SC_COST] = w[3] * scale
    cand[SC_ENERGY] = w[4] * scale
    return [cand.astype(np.float32)]


def gavel_candidates(
    cost_milli: np.ndarray,
    energy_milli: np.ndarray,
    accel_class: np.ndarray,
    valid: np.ndarray,
) -> List[np.ndarray]:
    """Gavel-style heterogeneity-aware candidates: cost/energy pressure
    normalized by the accelerator-class throughput proxy. ``accel_class``
    is an interned class id (-1 = unlabeled); classes rank throughput in
    interning order, so class id + 1 is the throughput scale the $-term
    divides by. Empty on a fleet with no cost/energy labels — Gavel has
    nothing to normalize."""
    mask = np.asarray(valid, bool)
    if not mask.any():
        return []
    cost = np.asarray(cost_milli, np.float64)[mask]
    energy = np.asarray(energy_milli, np.float64)[mask]
    accel = np.asarray(accel_class, np.float64)[mask]
    if cost.max(initial=0.0) <= 0 and energy.max(initial=0.0) <= 0:
        return []
    throughput = np.maximum(accel + 1.0, 1.0)  # -1/0 → baseline class
    out = []
    if cost.max(initial=0.0) > 0:
        norm_cost = cost / throughput
        # dispersion of $/throughput decides how hard the vector leans:
        # a fleet where every node costs the same per unit of throughput
        # gains nothing from cost-aware placement
        spread = norm_cost.std() / max(norm_cost.mean(), 1e-9)
        cand = WEIGHT_PROFILES["pack"].copy()
        cand[SC_COST] = np.float32(100.0 * min(1.0, spread + 0.1))
        out.append(cand.astype(np.float32))
    if energy.max(initial=0.0) > 0:
        norm_energy = energy / throughput
        spread = norm_energy.std() / max(norm_energy.mean(), 1e-9)
        cand = WEIGHT_PROFILES["pack"].copy()
        cand[SC_ENERGY] = np.float32(100.0 * min(1.0, spread + 0.1))
        out.append(cand.astype(np.float32))
    return out


def profile_candidates() -> List[Tuple[str, np.ndarray]]:
    """The built-in named profiles: free candidates with stable names —
    the fast path for workload flips whose winner IS a known policy
    (cost pressure appears → "cheapest" wins shadow within windows,
    no gradient walk needed)."""
    return [
        (name, vec.copy())
        for name, vec in WEIGHT_PROFILES.items()
        if name != "spread"  # alias of default — no information
    ]
