"""Score constants, Stage-A filter/score primitives and kernel-output guards.

Port of the part of ``kubernetes_tpu/ops/lattice.py`` that the wave kernel
imports (``wavelattice.py:57-75``) plus the batch guards the scheduler runs
on every read-back result. The serial scan lattice
(``make_schedule_batch_raw``, ``make_schedule_batch``) and the preemption
what-if (``preempt_whatif``) are later slices.

The reference evaluates one pod (or template) per call and ``jax.vmap``s
over the batch. Here every primitive takes a ``PodBatch`` whose fields
carry a leading template axis ``[B, ...]`` and returns ``[B, N]`` — the
batch dimension written out. Node-axis gathers read the snapshot's
transposed columns (``label_vals.T[key]``) so the node axis lands last.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .batch import TOL_OP_EXISTS
from .encoding import (
    DeviceSnapshot,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    ENC_OP_EXISTS,
    ENC_OP_GT,
    ENC_OP_IN,
    ENC_OP_LT,
    ENC_OP_NOT_EXISTS,
    ENC_OP_NOT_IN,
    PodBatch,
)

INT_MIN = int(np.iinfo(np.int32).min)

# Score component indices (fixed order; weights vector selects the profile).
SC_LEAST_ALLOC = 0
SC_MOST_ALLOC = 1
SC_BALANCED = 2
SC_REQ_TO_CAP = 3
SC_NODE_AFFINITY = 4
SC_TAINT = 5
SC_IMAGE = 6
SC_PREFER_AVOID = 7
SC_TOPO_SPREAD = 8
SC_INTERPOD = 9
SC_SELECTOR_SPREAD = 10  # DefaultPodTopologySpread (same-service pod count)
# heterogeneity/cost components (encoding's per-node column family):
# normalized-inverted within the feasible set, so a cheaper / lower-energy
# node scores higher; an unlabeled (all-zero) cluster scores flat
SC_COST = 11  # cost-per-hour (snap.cost_milli)
SC_ENERGY = 12  # energy proxy (snap.energy_milli)
NUM_SCORE_COMPONENTS = 13

# Default profile weights: all 1 except NodePreferAvoidPods=10000
# (algorithmprovider/registry.go:61-131).
DEFAULT_WEIGHTS = np.ones(NUM_SCORE_COMPONENTS, np.float32)
DEFAULT_WEIGHTS[SC_PREFER_AVOID] = 10000.0
# MostAllocated / RequestedToCapacityRatio are not in the default profile.
DEFAULT_WEIGHTS[SC_MOST_ALLOC] = 0.0
DEFAULT_WEIGHTS[SC_REQ_TO_CAP] = 0.0
# cost/energy are policy opt-ins, never part of the reference default
DEFAULT_WEIGHTS[SC_COST] = 0.0
DEFAULT_WEIGHTS[SC_ENERGY] = 0.0


def _profile(**overrides) -> np.ndarray:
    w = DEFAULT_WEIGHTS.copy()
    for name, val in overrides.items():
        w[globals()[name]] = val
    return w


# Named score policies: pluggable score matrices selected by a RUNTIME
# weight vector (a kernel input — swapping policies changes no code path).
WEIGHT_PROFILES = {
    "default": DEFAULT_WEIGHTS.copy(),
    # bin-pack: fill the fullest feasible node first
    "pack": _profile(SC_LEAST_ALLOC=0.0, SC_MOST_ALLOC=1.0),
    # spread: the default profile's LeastAllocated already spreads; name it
    "spread": DEFAULT_WEIGHTS.copy(),
    # heterogeneity/cost: cheapest feasible node dominates, pack breaks ties
    "cheapest": _profile(
        SC_LEAST_ALLOC=0.0, SC_MOST_ALLOC=1.0, SC_COST=100.0
    ),
    # energy-aware: minimize the fleet energy proxy, pack breaks ties
    "energy": _profile(
        SC_LEAST_ALLOC=0.0, SC_MOST_ALLOC=1.0, SC_ENERGY=100.0
    ),
}


def weights_for_policy(policy) -> np.ndarray:
    """Resolve a policy name or raw vector into a weight vector. Unknown
    names raise (a typo'd policy must fail loudly at config time, not
    schedule with silently-default weights). Raw vectors are validated
    for shape, dtype-coercibility AND finiteness here — a NaN/inf weight
    would otherwise poison every score in the next kernel launch and
    surface as an inscrutable guard trip instead of a ValueError at the
    call that introduced it."""
    if isinstance(policy, str):
        try:
            return WEIGHT_PROFILES[policy].copy()
        except KeyError:
            raise ValueError(
                f"unknown score policy {policy!r}; known: "
                f"{sorted(WEIGHT_PROFILES)}"
            ) from None
    try:
        w = np.asarray(policy, np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"score weight vector is not float32-coercible: {e}"
        ) from None
    if w.shape != (NUM_SCORE_COMPONENTS,):
        raise ValueError(
            f"score weight vector must have shape ({NUM_SCORE_COMPONENTS},), "
            f"got {w.shape}"
        )
    if not np.isfinite(w).all():
        bad = np.flatnonzero(~np.isfinite(w)).tolist()
        raise ValueError(
            f"score weight vector has non-finite components at {bad}"
        )
    return w.copy()


IMG_MIN_THRESHOLD = 23.0 * 1024 * 1024  # imagelocality minThreshold
IMG_MAX_THRESHOLD = 1000.0 * 1024 * 1024


# ---------------------------------------------------------------------------
# expression / selector evaluation (stage A primitives)
# ---------------------------------------------------------------------------


def _label_cols(
    snap: DeviceSnapshot, key: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node label value-id and numeric value for key ids of any shape
    S, as ``[*S, N]``. key < 0 (absent/unknown) yields value -1 / INT_MIN
    (label absent); the key index is clamped as the reference clamps it."""
    k = key.clamp(0, snap.label_vals.shape[1] - 1).long()
    vals = snap.label_vals.T[k]
    nums = snap.label_numvals.T[k]
    absent = (key < 0)[..., None]
    return torch.where(absent, -1, vals), torch.where(absent, INT_MIN, nums)


def _expr_mask(snap: DeviceSnapshot, key, op, vals, num) -> torch.Tensor:
    """``[*S, N]`` bool: nodes matching each NodeSelectorRequirement
    (key/op/num ``[*S]``, vals ``[*S, V]``). Empty slot (op == -1) matches
    everything (AND identity)."""
    labval, labnum = _label_cols(snap, key)  # [*S, N]
    has = labval >= 0
    # one compare per value slot keeps the intermediate at [*S, N]
    in_set = torch.zeros_like(has)
    for v in range(vals.shape[-1]):
        in_set |= labval == vals[..., v, None]
    in_set &= has
    has_num = labnum != INT_MIN
    op = op[..., None]
    num = num[..., None]
    cases = [
        (ENC_OP_IN, in_set),
        (ENC_OP_NOT_IN, ~in_set),  # NotIn: absent key also passes
        (ENC_OP_EXISTS, has),
        (ENC_OP_NOT_EXISTS, ~has),
        (ENC_OP_GT, has_num & (labnum > num)),
        (ENC_OP_LT, has_num & (labnum < num)),
    ]
    # jnp.select: the first matching case wins, so fold from the last
    result = torch.ones_like(has)
    for code, val in reversed(cases):
        result = torch.where(op == code, val, result)
    return torch.where(op < 0, True, result)


def _term_mask(
    snap, keys, ops, vals, nums, name_row: Optional[torch.Tensor]
) -> torch.Tensor:
    """``[*S, N]`` bool for NodeSelectorTerms: AND of expressions (keys
    ``[*S, E]``) + the matchFields metadata.name row (None = no field)."""
    m = _expr_mask(snap, keys, ops, vals, nums).all(dim=-2)
    if name_row is None:
        return m
    rows = torch.arange(snap.valid.shape[0], device=m.device)
    nr = name_row[..., None]
    return m & torch.where(nr == -1, True, rows == nr)


def _node_affinity_required(snap, bp: PodBatch) -> torch.Tensor:
    """[B, N] bool: nodeSelector AND (OR of required nodeSelectorTerms).

    Mirrors PodMatchesNodeSelectorAndAffinityTerms
    (nodeaffinity/node_affinity.go:54 + v1helper)."""
    ns_ok = _term_mask(snap, bp.ns_key, bp.ns_op, bp.ns_vals, bp.ns_num, None)
    terms = _term_mask(
        snap, bp.aff_key, bp.aff_op, bp.aff_vals, bp.aff_num,
        bp.aff_match_name_row,
    )  # [B, T, N]
    any_term = (terms & bp.aff_term_valid[..., None]).any(dim=1)
    aff_ok = torch.where(bp.aff_has[:, None], any_term, True)
    return ns_ok & aff_ok


def _node_affinity_score(snap, bp: PodBatch) -> torch.Tensor:
    """[B, N] float: Σ weights of matched preferred terms (pre-normalization)."""
    terms = _term_mask(
        snap, bp.pref_key, bp.pref_op, bp.pref_vals, bp.pref_num, None
    )  # [B, PT, N]
    w = torch.where(bp.pref_term_valid, bp.pref_weight, 0.0)
    return (terms.float() * w[..., None]).sum(dim=1)


def _taints(snap, bp: PodBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, N] bool tolerated-for-schedule, [B, N] float intolerable-prefer
    count).

    Filter: untolerated NoSchedule/NoExecute ⇒ infeasible
    (tainttoleration/taint_toleration.go:55-77, UnschedulableAndUnresolvable).
    Score: count of intolerable PreferNoSchedule taints (129-167)."""
    tk, tv, te = snap.taint_key, snap.taint_val, snap.taint_effect  # [N, TA]
    jk, jop, jv, je = (
        x[:, :, None, None]
        for x in (bp.tol_key, bp.tol_op, bp.tol_val, bp.tol_effect)
    )  # [B, TO, 1, 1]
    key_ok = (jk == -1) | (jk == tk)
    val_ok = (jop == TOL_OP_EXISTS) | (jv == tv)
    eff_ok = (je == -1) | (je == te)
    tol = (jop >= 0) & key_ok & val_ok & eff_ok  # [B, TO, N, TA]
    tolerated = tol.any(dim=1)  # [B, N, TA]
    active = tk >= 0
    hard = active & ((te == EFFECT_NO_SCHEDULE) | (te == EFFECT_NO_EXECUTE))
    ok = (~hard | tolerated).all(dim=-1)
    prefer = active & (te == EFFECT_PREFER_NO_SCHEDULE)
    intolerable = (prefer & ~tolerated).float().sum(dim=-1)
    return ok, intolerable


def _image_locality(snap, bp: PodBatch) -> torch.Tensor:
    """[B, N] float 0..100 (imagelocality/image_locality.go:47)."""
    n_valid = snap.valid.float().sum().clamp(min=1.0)
    have = (snap.image_bytes > 0).float()  # [N, I]
    spread = have.sum(dim=0) / n_valid  # [I] fraction of nodes w/ image
    iid = bp.image_ids.clamp(0, snap.image_bytes.shape[1] - 1).long()  # [B, IM]
    use = (bp.image_ids >= 0).float()
    sizes = snap.image_bytes.T[iid] * use[..., None]  # [B, IM, N]
    scaled = sizes * spread[iid][..., None]
    total = scaled.sum(dim=1)  # [B, N]
    score = (
        (total - IMG_MIN_THRESHOLD)
        / (IMG_MAX_THRESHOLD - IMG_MIN_THRESHOLD)
        * 100.0
    )
    return score.clamp(0.0, 100.0)


def _prefer_avoid(snap, bp: PodBatch) -> torch.Tensor:
    """[B, N] float: 0 if node's avoid-annotation lists the pod's controller,
    else 100 (nodepreferavoidpods/node_prefer_avoid_pods.go:39)."""
    a = bp.ctrl_id.clamp(0, snap.avoid.shape[1] - 1).long()
    avoided = snap.avoid.T[a] & (bp.ctrl_id >= 0)[:, None]
    return torch.where(avoided, 0.0, 100.0)


# -- kernel-output guards (scheduler data-plane self-defense) ----------------

GUARD_ROW_RANGE = "row_out_of_range"
GUARD_NONFINITE = "nonfinite_score"
# split-phase readback: the trailing bulk transfer died after the fast
# index payload already drove assumes — the batch's device commits are
# unverifiable and must quarantine/unwind
GUARD_TRAILING_LOSS = "trailing_readback_loss"


class KernelGuardTrip(RuntimeError):
    """A batch's read-back results failed validation: the whole batch must
    be quarantined to the host fallback path and the device snapshot
    rebuilt (its commits for this batch are suspect)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"kernel guard trip: {reason} {detail}".rstrip())
        self.reason = reason


def validate_batch_outputs(chosen, placed, score, n_rows: int):
    """Cheap structural validation of a read-back batch result BEFORE any
    placement is acted on: every placed pod's chosen row must name a live
    node row (negative or past-capacity indices would mis-index
    row_names — numpy's negative wrap silently picks the WRONG node), and
    its score must be finite (a NaN/Inf in the score matrix poisons the
    argmax for the whole column). Returns a trip reason or None."""
    placed = np.asarray(placed, dtype=bool)
    if not placed.any():
        return None
    rows = np.asarray(chosen)[placed]
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        return GUARD_ROW_RANGE
    if score is not None:
        s = np.asarray(score)[placed]
        if not np.isfinite(s).all():
            return GUARD_NONFINITE
    return None


def validate_trailing_score(score, placed):
    """Split-phase trailing validation: the fast index payload was
    validated (and acted on) with score=None; when the bulk score vector
    lands it must agree that every placed pod scored finite — a NaN/Inf
    here means the argmax the fast payload reported was computed over a
    poisoned column. Returns a trip reason or None."""
    placed = np.asarray(placed, dtype=bool)
    if score is None or not placed.any():
        return None
    s = np.asarray(score)[placed]
    if not np.isfinite(s).all():
        return GUARD_NONFINITE
    return None
