"""Score constants, Stage-A filter/score primitives, the serial batch
kernel and the kernel-output guards.

Port of ``kubernetes_tpu/ops/lattice.py``: the Stage-A helpers the wave
kernel imports (``wavelattice.py:57-75``), ``_pod_static`` (the one
definition of Stage A that the serial kernel, the preemption what-if and
the victim selection of ``ops/preemptlattice.py`` share), the serial
scan lattice (``make_schedule_batch_raw`` / ``make_schedule_batch``, the
``use_wave=False`` path and the warm standby's pre-warm), the preemption
what-if (``preempt_whatif``) and the batch guards the scheduler runs on
every read-back result.

The reference evaluates one pod (or template) per call and ``jax.vmap``s
over the batch. Here every primitive takes a ``PodBatch`` whose fields
carry a leading template axis ``[B, ...]`` and returns ``[B, N]`` — the
batch dimension written out. Node-axis gathers read the snapshot's
transposed columns (``label_vals.T[key]``) so the node axis lands last.

The serial kernel (``ScheduleBatch``) is the reference's ``lax.scan`` over
pods as a Python loop whose every step is vectorized over its term axes:
the spread, incoming (anti-)affinity, preferred and existing-pod terms of
one pod go through ONE ``scatter_add_`` into a ``[terms, v_cap + 1]``
buffer (the spare segment takes the rows the reference's ``segment_sum``
drops). The loop issues no host sync: the chosen row, the gate and every
carry update stay on the device (``index_add_`` at the chosen row, adding
zeros when the pod is not placed). The integer carries (free resources,
scoring requests, predicate counts, host ports) are kept summed with the
snapshot's columns, which equals the reference's ``snapshot + carry`` in
integer arithmetic; the float existing-term weights keep the reference's
separate carry. The per-pod ``jax.random.split`` / ``uniform`` tie noise is
an input: a ``[P, N]`` float32 tensor in [0, 1) on the snapshot's device.
XLA's CPU reduce of the weighted score components is a fused
multiply-add chain; ``_dot_fma`` reproduces it.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

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
    ETERM_AFF_PREF,
    ETERM_AFF_REQ,
    ETERM_ANTI_PREF,
    ETERM_ANTI_REQ,
    RES_CPU,
    RES_MEM,
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


# Names a promoted/tuned vector may never shadow: the built-in profiles
# are documented identities ("cheapest" must keep meaning cheapest).
_BUILTIN_PROFILES = frozenset(WEIGHT_PROFILES)


def register_weight_profile(
    name: str, vec, overwrite: bool = False
) -> np.ndarray:
    """Register a named weight profile at runtime so promoted vectors get
    STABLE names in metrics labels, SIGUSR2 dumps and the persisted
    score-policy object (the policy gym calls this before
    ``set_score_policy``; an HA standby calls it while adopting the
    persisted policy). The vector passes the full ``weights_for_policy``
    raw-vector validation; built-in profile names are reserved, and
    re-registering a tuned name requires ``overwrite=True`` unless the
    vector is unchanged (idempotent re-adoption)."""
    if not name or not isinstance(name, str):
        raise ValueError("profile name must be a non-empty string")
    w = weights_for_policy(np.asarray(vec))
    if name in _BUILTIN_PROFILES:
        raise ValueError(
            f"profile name {name!r} is reserved (built-in profile)"
        )
    existing = WEIGHT_PROFILES.get(name)
    if existing is not None and not overwrite and not np.array_equal(
        existing, w
    ):
        raise ValueError(
            f"profile {name!r} already registered with different weights "
            "(pass overwrite=True to replace)"
        )
    WEIGHT_PROFILES[name] = w.copy()
    return w


IMG_MIN_THRESHOLD = 23.0 * 1024 * 1024  # imagelocality minThreshold
IMG_MAX_THRESHOLD = 1000.0 * 1024 * 1024


class BatchResult(NamedTuple):
    chosen: Any  # [P] int32 node row, -1 = unschedulable (or invalid pod)
    score: Any  # [P] float32 winning weighted score
    feasible_count: Any  # [P] int32 number of feasible nodes at decision time
    resolvable: Any  # [P, N] bool — infeasible but preemption might help
    # (passes all UnschedulableAndUnresolvable-class filters)


def _dot_fma(coef, mats):
    """Σ_k coef[..., k] * mats[k] in the order of XLA's CPU reduction: a
    sequential fused multiply-add chain rounded to float32 at every step
    (each product is exact in float64, each sum rounds once).
    coef [..., K] (broadcast against mats[k]), mats [K, ...] float32."""
    coef = coef.double()
    acc = None
    for k in range(mats.shape[0]):
        term = coef[..., k, None] * mats[k]
        acc = (term if acc is None else term + acc).float()
    return acc


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
    snap, keys, ops, vals, nums, name_row: Optional[torch.Tensor], base: int = 0
) -> torch.Tensor:
    """``[*S, N]`` bool for NodeSelectorTerms: AND of expressions (keys
    ``[*S, E]``) + the matchFields metadata.name row (None = no field).
    `base` is the global row of the snapshot's first row (a shard's)."""
    m = _expr_mask(snap, keys, ops, vals, nums).all(dim=-2)
    if name_row is None:
        return m
    rows = torch.arange(base, base + snap.valid.shape[0], device=m.device)
    nr = name_row[..., None]
    return m & torch.where(nr == -1, True, rows == nr)


def _node_affinity_required(snap, bp: PodBatch, base: int = 0) -> torch.Tensor:
    """[B, N] bool: nodeSelector AND (OR of required nodeSelectorTerms).

    Mirrors PodMatchesNodeSelectorAndAffinityTerms
    (nodeaffinity/node_affinity.go:54 + v1helper)."""
    ns_ok = _term_mask(snap, bp.ns_key, bp.ns_op, bp.ns_vals, bp.ns_num, None)
    terms = _term_mask(
        snap, bp.aff_key, bp.aff_op, bp.aff_vals, bp.aff_num,
        bp.aff_match_name_row, base,
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


def _image_counts(snap) -> Tuple[torch.Tensor, torch.Tensor]:
    """(live nodes, live-or-not nodes holding each image [I]): the counts
    the image spread divides, partial on a shard (they add up)."""
    return snap.valid.float().sum(), (snap.image_bytes > 0).float().sum(dim=0)


def _image_locality(snap, bp: PodBatch, counts=None) -> torch.Tensor:
    """[B, N] float 0..100 (imagelocality/image_locality.go:47). `counts`:
    the :func:`_image_counts` of every node when `snap` is one shard's
    rows (None: this snapshot's own)."""
    if counts is None:
        n_valid = snap.valid.float().sum().clamp(min=1.0)
        have = (snap.image_bytes > 0).float()  # [N, I]
        spread = have.sum(dim=0) / n_valid  # [I] fraction of nodes w/ image
    else:
        spread = counts[1] / counts[0].clamp(min=1.0)
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


# Stage A runs over the batch in chunks of pods so that its largest
# intermediate (the [B, terms, exprs, N] node-affinity expression planes,
# the [B, tolerations, N, taints] toleration match) stays near this many
# elements: a 4096-pod batch over 8192 rows would otherwise hold several
# of them at GiBs each. Chunking changes no value.
_STAGE_A_ELEMENTS = 1 << 26


def _pod_static_chunk(snap: DeviceSnapshot, bp: PodBatch, counts=None, base: int = 0) -> Tuple:
    n = snap.valid.shape[0]
    rows = torch.arange(base, base + n, device=snap.valid.device)
    ns_aff = _node_affinity_required(snap, bp, base)
    taint_ok, prefer_cnt = _taints(snap, bp)
    unsched_ok = ~snap.unschedulable[None, :] | bp.tolerates_unschedulable[:, None]
    nr = bp.node_name_row[:, None]
    name_ok = torch.where(
        nr == -1, True, torch.where(nr < 0, False, rows[None, :] == nr)
    )
    static_ok = snap.valid[None, :] & ns_aff & taint_ok & unsched_ok & name_ok
    # Scores computed regardless of feasibility; normalization masks later.
    aff_score = _node_affinity_score(snap, bp)
    img = _image_locality(snap, bp, counts)
    avoid = _prefer_avoid(snap, bp)
    return static_ok, ns_aff, aff_score, prefer_cnt, img, avoid


def _pod_static(snap: DeviceSnapshot, batch: PodBatch, counts=None, base: int = 0) -> Tuple:
    """Stage A for a batch: static mask/score pieces, each [P, N].
    Returns (static_ok, ns_aff_mask, aff_score, prefer_cnt, img, avoid).
    Shared by the schedule kernel, the preemption what-if and the victim
    selection (static_ok is exactly the UnschedulableAndUnresolvable
    boundary: nodes failing it cannot be helped by evictions,
    generic_scheduler.go:1033). On one shard's rows, `counts` are every
    node's image counts and `base` the shard's first global row."""
    n = snap.valid.shape[0]
    p = batch.valid.shape[0]
    width = max(
        batch.aff_key.shape[1] * batch.aff_key.shape[2],
        batch.pref_key.shape[1] * batch.pref_key.shape[2],
        batch.tol_key.shape[1] * snap.taint_key.shape[1],
        batch.image_ids.shape[1],
        1,
    )
    step = max(1, _STAGE_A_ELEMENTS // (width * max(n, 1)))
    if p <= step:
        return _pod_static_chunk(snap, batch, counts, base)
    parts = [
        _pod_static_chunk(snap, PodBatch(*(f[s:s + step] for f in batch)), counts, base)
        for s in range(0, p, step)
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


# ---------------------------------------------------------------------------
# stage B primitives (carry-dependent)
# ---------------------------------------------------------------------------


def _gather_counts(counts: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """[K, N] float pod-match counts for predicates sid [K] (< 0 → zeros);
    counts [N, S] is the live count (the reference's counts + extra)."""
    c = counts.T[sid.clamp(0, counts.shape[1] - 1).long()]
    return torch.where((sid >= 0)[:, None], c.to(torch.float32), 0.0)


def _domain_sums(dom: torch.Tensor, weights: torch.Tensor, ok: torch.Tensor, v_cap: int):
    """Per-topology-domain reduction for K terms at once (the first half
    of the reference's per-term ``_domain_ops``, vmapped): ``weights``
    [K, N] are summed per domain (dom [K, N], the node's value id of each
    term's topology key, -1 = key absent) over the nodes where ``ok``
    (has the key and is eligible). One scatter_add_ into [K, v_cap + 1];
    the spare segment v_cap takes the rows the reference's segment_sum
    drops. Returns (sums [K, v_cap], seg [K, N]): on a shard the sums are
    its partial sums (domain ids are global, so partials add up)."""
    seg = torch.where(ok, dom, v_cap).clamp(max=v_cap).long()
    sums = torch.zeros(
        (dom.shape[0], v_cap + 1), dtype=torch.float32, device=dom.device
    ).scatter_add_(1, seg, torch.where(ok, weights, 0.0))[:, :v_cap]
    return sums, seg


def _node_sums(dom: torch.Tensor, sums: torch.Tensor, v_cap: int) -> torch.Tensor:
    """Each node's own domain's sum (the second half of ``_domain_ops``),
    [K, N]; 0 where the node lacks the key."""
    return torch.where(
        dom >= 0, sums.gather(1, dom.clamp(0, v_cap - 1).long()), 0.0
    )


class Merge(NamedTuple):
    """A merge across the shards of a node-sharded kernel, asked for by a
    block generator (``ScheduleBatch._block``, ``WaveKernel._stage_a``):
    ``op`` is "sum", "max" or "any" (the merged value goes back to every
    shard), "argmax" (``value`` = (local maximum, its global row): the
    global row of the first maximum, to every shard) or "top" (``value`` =
    (scores, global rows), each shard's stable descending top list: the
    global top ``m`` ordered by score, ties by global row, kept on the
    mesh's first device). On one
    device every merge is the identity (:func:`run_local`)."""

    op: str
    value: Any
    m: int = 0


def run_local(gen):
    """Drive a block generator over the whole snapshot on one device:
    each merge request is answered with its own value (one block merges
    with nothing), so the generator's launches are exactly its own."""
    sent = None
    while True:
        try:
            req = gen.send(sent)
        except StopIteration as stop:
            return stop.value
        sent = {k: r.value for k, r in req.items()}


class ScheduleBatch:
    """The serial batch kernel for a domain-segment capacity (the
    reference's ``make_schedule_batch_raw`` closure). Call it as
    ``kernel(snap, batch, weights, noise)``: ``weights`` the [K] score
    weight vector, ``noise`` the [P, N] float32 tie noise in [0, 1) on
    the snapshot's device (the reference's per-pod ``uniform(key, (N,))``).
    Pods are placed one after another, each seeing the batch's earlier
    placements (the scan carry). The snapshot is read, never written.
    Returns a BatchResult."""

    def __init__(self, v_cap: int, hard_pod_affinity_weight: float = 1.0):
        self.v_cap = v_cap
        self.hard_pod_affinity_weight = float(hard_pod_affinity_weight)

    def __call__(self, snap: DeviceSnapshot, batch: PodBatch, weights, noise) -> BatchResult:
        n = snap.valid.shape[0]
        p = batch.valid.shape[0]
        if tuple(noise.shape) != (p, n):
            raise ValueError(f"tie noise is {tuple(noise.shape)}, want {(p, n)}")
        return run_local(self._block(snap, batch, weights, noise))

    def _block(self, snap: DeviceSnapshot, batch: PodBatch, weights, noise, shard=None):
        """The kernel on one block of node rows: the whole snapshot
        (shard None), or rows [shard, shard + N_block) of a node-sharded
        one (``parallel/sharded.ShardedScheduleBatch``), with `noise` the
        block's columns of the [P, N] draw. A generator: every pod step
        yields its cross-shard merges as :class:`Merge` requests — the
        domain sums and their presence, the score maxima and the feasible
        count, the best score, and (sharded) the argmax, ties to the
        lower global row — and commits the carry only where the chosen
        row is the block's own. Returns the block's BatchResult
        (``resolvable`` has the block's columns; the rest is global)."""
        v_cap = self.v_cap
        dev = snap.valid.device
        f32 = torch.float32
        n = snap.valid.shape[0]
        p = batch.valid.shape[0]
        weights = torch.as_tensor(weights, dtype=f32).to(dev)
        counts = None
        if shard is not None:
            # the image spread is over every node
            n_valid, have = _image_counts(snap)
            got = yield {"n_valid": Merge("sum", n_valid), "have": Merge("sum", have)}
            counts = (got["n_valid"], got["have"])
        static_ok, ns_aff, aff_score, prefer_cnt, img, avoid = _pod_static(
            snap, batch, counts, shard or 0
        )

        # ---- batch-invariant pieces ----
        valid = snap.valid
        r = snap.allocatable.shape[1]
        s_cap = snap.sel_counts.shape[1]
        lv_t = snap.label_vals.T  # [L, N]
        n_keys = lv_t.shape[0]

        def dom_of(key):  # [K] topology key ids -> [K, N] value ids, -1 absent
            return torch.where(
                (key < 0)[:, None], -1, lv_t[key.clamp(0, n_keys - 1).long()]
            )

        dom_e = dom_of(snap.eterm_topo_key)  # [T, N]
        e_anti = snap.eterm_kind == ETERM_ANTI_REQ
        sgn = torch.zeros(snap.eterm_kind.shape, dtype=f32, device=dev)
        for kind, val in (
            (ETERM_ANTI_PREF, -1.0),
            (ETERM_AFF_PREF, 1.0),
            (ETERM_AFF_REQ, self.hard_pod_affinity_weight),
        ):
            sgn = torch.where(snap.eterm_kind == kind, val, sgn)
        alloc_f = snap.allocatable.to(f32).clamp(min=1.0)
        alloc_cpu, alloc_mem = alloc_f[:, RES_CPU], alloc_f[:, RES_MEM]
        cost_f = snap.cost_milli.to(f32)
        energy_f = snap.energy_milli.to(f32)

        # the pod's own terms on one axis: spread C | affinity A | anti B |
        # preferred W; the existing pods' T terms follow in every step
        n_c = batch.spread_key.shape[1]
        n_a = batch.paff_sid.shape[1]
        n_b = batch.panti_sid.shape[1]
        a0, b0, w0 = n_c, n_c + n_a, n_c + n_a + n_b
        k_pod = w0 + batch.ppref_sid.shape[1]
        pkey = torch.cat(
            [batch.spread_key, batch.paff_key, batch.panti_key, batch.ppref_key], 1
        )
        psid = torch.cat(
            [batch.spread_sid, batch.paff_sid, batch.panti_sid, batch.ppref_sid], 1
        )
        s_active = batch.spread_key >= 0
        s_hard = s_active & batch.spread_hard
        s_soft = (s_active & ~batch.spread_hard).to(f32)
        s_self = torch.where(batch.spread_self, 1.0, 0.0)
        s_skew = batch.spread_skew.to(f32)
        a_used = batch.paff_sid >= 0
        b_used = batch.panti_sid >= 0
        w_pref = torch.where(batch.ppref_sid >= 0, batch.ppref_w, 0.0)
        e_bad_of = batch.match_eterm & e_anti[None, :]  # [P, T]
        e_sgn = torch.where(batch.match_eterm, sgn[None, :], 0.0)  # [P, T]
        nz_cpu = batch.nonzero_req[:, RES_CPU]
        nz_mem = batch.nonzero_req[:, RES_MEM]

        # integer carry, summed with the snapshot: free | scoring requests
        # | predicate counts | host ports; `delta` is each pod's commit
        cur = torch.cat(
            [
                snap.allocatable - snap.requested,
                snap.nonzero_req,
                snap.sel_counts,
                snap.port_counts,
            ],
            1,
        )
        free_c = cur[:, :r]
        nz_c = cur[:, r:2 * r]
        sel_c = cur[:, 2 * r:2 * r + s_cap]
        port_c = cur[:, 2 * r + s_cap:]
        delta = torch.cat(
            [
                -batch.req,
                batch.nonzero_req,
                batch.match_sel.to(torch.int32),
                batch.port_mask.to(torch.int32),
            ],
            1,
        )
        et_x = torch.zeros_like(snap.eterm_w)
        inf = float("inf")

        def masked_max(x, feasible):
            return torch.where(feasible, x, -inf).amax()

        def norm_max(x, mx):
            safe = torch.where(torch.isfinite(mx) & (mx > 0), mx, 1.0)
            return (x / safe * 100.0).clamp(0.0, 100.0)

        def norm_invert(x, mx):  # lower raw -> higher score
            ok = torch.isfinite(mx) & (mx > 0)
            safe = torch.where(ok, mx, 1.0)
            return torch.where(ok, (safe - x) / safe * 100.0, 100.0)

        chosen_out, score_out, feas_out = [], [], []
        resolvable = torch.empty((p, n), dtype=torch.bool, device=dev)
        for i in range(p):
            # --- NodeResourcesFit, NodePorts ---
            req = batch.req[i]
            fits = ((req == 0) | (req <= free_c)).all(dim=1)
            port_conflict = (batch.port_mask[i] & (port_c > 0)).any(dim=1)

            # --- every domain term of this step: one scatter ---
            dom = torch.cat([dom_of(pkey[i]), dom_e])  # [K, N]
            w = torch.cat(
                [_gather_counts(sel_c, psid[i]), (snap.eterm_w + et_x).T]
            )
            has_key = dom >= 0
            ok = has_key & valid
            ok[:n_c] &= ns_aff[i]  # spread counts only affinity-eligible nodes
            sums, seg = _domain_sums(dom, w, ok, v_cap)
            present = torch.zeros(
                (n_c, v_cap + 1), dtype=torch.int32, device=dev
            ).scatter_reduce_(1, seg[:n_c], ok[:n_c].to(torch.int32), "amax")
            got = yield {"sums": Merge("sum", sums), "present": Merge("max", present)}
            sums, present = got["sums"], got["present"]
            node_sum = _node_sums(dom, sums, v_cap)

            # --- PodTopologySpread (podtopologyspread/filtering.go) ---
            min_dom = torch.where(present[:, :v_cap] > 0, sums[:n_c], inf).amin(dim=1)
            m = torch.where(torch.isfinite(min_dom), min_dom, 0.0)
            ns_s = node_sum[:n_c]
            skewed = ns_s + s_self[i, :, None] - m[:, None] > s_skew[i, :, None]
            hard_bad = s_hard[i, :, None] & (skewed | ~has_key[:n_c])
            spread_ok = ~hard_bad.any(dim=0)
            spread_penalty = (s_soft[i, :, None] * ns_s).sum(dim=0)

            # --- InterPodAffinity: the incoming pod's required terms ---
            ns_a = node_sum[a0:b0]
            total_a = sums[a0:b0].sum(dim=1)
            aff_ok = (
                ~a_used[i, :, None]
                | (ns_a > 0)
                | ((total_a == 0) & batch.paff_self[i])[:, None] & has_key[a0:b0]
            ).all(dim=0)
            anti_bad = (
                b_used[i, :, None] & has_key[b0:w0] & (node_sum[b0:w0] > 0)
            ).any(dim=0)

            # --- existing pods' terms (eterms) + incoming preferred terms ---
            ns_e = node_sum[k_pod:]
            eterm_bad = (e_bad_of[i, :, None] & has_key[k_pod:] & (ns_e > 0)).any(dim=0)
            interpod = (e_sgn[i, :, None] * ns_e).sum(dim=0) + (
                w_pref[i, :, None] * node_sum[w0:k_pod]
            ).sum(dim=0)

            # --- combine mask ---
            feasible = (
                static_ok[i] & fits & ~port_conflict & spread_ok & aff_ok
                & ~anti_bad & ~eterm_bad
            )
            # preemption-candidate nodes: fail only resolvable filters
            torch.logical_and(static_ok[i], ~feasible, out=resolvable[i])

            # --- scores (normalized 0..100 over feasible, framework.go:503-580) ---
            # resource scores include the incoming pod (least_allocated.go:77-99)
            cpu_f = ((nz_c[:, RES_CPU] + nz_cpu[i]).to(f32) / alloc_cpu).clamp(0.0, 1.0)
            mem_f = ((nz_c[:, RES_MEM] + nz_mem[i]).to(f32) / alloc_mem).clamp(0.0, 1.0)
            least = ((1.0 - cpu_f) * 100.0 + (1.0 - mem_f) * 100.0) / 2.0
            most = (cpu_f * 100.0 + mem_f * 100.0) / 2.0
            balanced = (1.0 - (cpu_f - mem_f).abs()) * 100.0
            # requested-to-capacity-ratio, default shape {0:0, 100:10}
            # scaled to 0..100 (requested_to_capacity_ratio.go:33)
            util = (cpu_f + mem_f) / 2.0 * 100.0
            rtc = util / 100.0 * 10.0 * 10.0
            # interpod: shift-free max-|score| normalization
            # (interpodaffinity/scoring.go:287-310)
            ip_max = torch.where(feasible, interpod.abs(), 0.0).amax()
            # DefaultPodTopologySpread: same-service pods per node; MAX over
            # the matching services
            svc_cnt = torch.where(
                batch.match_svc[i][None, :], sel_c.to(f32), 0.0
            ).amax(dim=1)
            # the normalizations' maxima and the feasible count are over
            # every node: merged across shards
            aff_i, prefer_i = aff_score[i], prefer_cnt[i]
            got = yield {
                "ip_max": Merge("max", ip_max),
                "aff": Merge("max", masked_max(aff_i, feasible)),
                "prefer": Merge("max", masked_max(prefer_i, feasible)),
                "spread": Merge("max", masked_max(spread_penalty, feasible)),
                "svc": Merge("max", masked_max(svc_cnt, feasible)),
                "cost": Merge("max", masked_max(cost_f, feasible)),
                "energy": Merge("max", masked_max(energy_f, feasible)),
                "feas": Merge("sum", feasible.sum(dtype=torch.int32)),
            }
            ip_max, feas_count = got["ip_max"], got["feas"]
            ip_norm = torch.where(ip_max > 0, interpod / ip_max * 100.0, 0.0)
            comps = torch.stack(
                [
                    least,
                    most,
                    balanced,
                    rtc,
                    norm_max(aff_i, got["aff"]),
                    norm_invert(prefer_i, got["prefer"]),
                    img[i],
                    avoid[i],
                    norm_invert(spread_penalty, got["spread"]),
                    ip_norm,
                    norm_invert(svc_cnt, got["svc"]),
                    norm_invert(cost_f, got["cost"]),
                    norm_invert(energy_f, got["energy"]),
                ]
            )  # [K, N]
            total_score = _dot_fma(weights, comps)

            # --- select: argmax with uniform random tie-break ---
            keyed = torch.where(feasible, total_score, -inf)
            best = (yield {"best": Merge("max", keyed.amax())})["best"]
            pick = torch.where(feasible & (keyed == best), noise[i], -1.0)
            chosen = pick.argmax()
            if shard is not None:
                # the first maximum over every node: ties to the lower
                # global row, as one device's argmax
                chosen = (yield {"pick": Merge("argmax", (pick.amax(), chosen + shard))})["pick"]
            placed = (feas_count > 0) & batch.valid[i]
            chosen_out.append(torch.where(placed, chosen, -1))
            score_out.append(torch.where(placed, best, -inf))
            feas_out.append(feas_count)

            # --- commit to the carry: zeros when not placed (or, on a
            # shard, when the chosen row is another block's) ---
            if shard is None:
                row = chosen.view(1)
            else:
                local = chosen - shard
                placed = placed & (local >= 0) & (local < n)
                row = local.clamp(0, n - 1).view(1)
            cur.index_add_(0, row, (delta[i] * placed)[None])
            et_x.index_add_(0, row, (batch.eterm_add[i] * placed)[None])

        return BatchResult(
            chosen=torch.stack(chosen_out).to(torch.int32),
            score=torch.stack(score_out),
            feasible_count=torch.stack(feas_out),
            resolvable=resolvable,
        )


@functools.lru_cache(maxsize=32)
def make_schedule_batch_raw(v_cap: int, hard_pod_affinity_weight: float = 1.0):
    """The serial batch kernel for a domain-segment capacity, cached per
    (v_cap, weight): a callable ``(snap, batch, weights, noise) ->
    BatchResult`` (see :class:`ScheduleBatch`)."""
    return ScheduleBatch(v_cap, hard_pod_affinity_weight)


# The reference jits make_schedule_batch_raw here; eager torch runs it as is.
make_schedule_batch = make_schedule_batch_raw


def preempt_whatif(
    snap: DeviceSnapshot, batch: PodBatch, priority: torch.Tensor
) -> torch.Tensor:
    """[B, N] bool batched masked preemption what-if (reference
    ``_preempt_whatif``, SURVEY §7.6): would pod (or template) b fit node n
    if every pod of lower priority there were evicted? OPTIMISTIC — it
    accounts resources (the priority-banded requested matrix) and the
    static UnschedulableAndUnresolvable filters (Stage A's static_ok), not
    affinity/spread terms contributed by would-be victims; the host
    reprieve loop re-checks the surviving candidates exactly, so false
    positives cost time, never correctness. `priority` [B] int32 rides
    outside the batch tensors. The [B, N, R] removable sum is a broadcast
    sum, not an einsum: CUDA has no integer matmul."""
    static_ok = _pod_static(snap, batch)[0]
    # removable[b, n, r] = sum over bands k with band_prio[k] < prio_b of
    # prio_req[n, k, r]
    removable_band = snap.band_prio[None, :] < priority[:, None]  # [B, PB]
    removable = (
        removable_band[:, None, :, None].to(snap.prio_req.dtype)
        * snap.prio_req[None]
    ).sum(dim=2, dtype=snap.prio_req.dtype)  # [B, N, R]
    free = snap.allocatable[None] - snap.requested[None] + removable
    req = batch.req[:, None, :]
    fits = ((req == 0) | (req <= free)).all(dim=-1)
    # a node already holding >= 1 lower-priority pod is the only kind where
    # eviction helps
    has_victims = (removable > 0).any(dim=-1)
    return static_ok & fits & has_victims & batch.valid[:, None]


# -- kernel-output guards (scheduler data-plane self-defense) ----------------

GUARD_ROW_RANGE = "row_out_of_range"
GUARD_NONFINITE = "nonfinite_score"
# split-phase readback: the trailing bulk transfer died after the fast
# index payload already drove assumes — the batch's device commits are
# unverifiable and must quarantine/unwind
GUARD_TRAILING_LOSS = "trailing_readback_loss"


class KernelGuardTrip(RuntimeError):
    """A batch's read-back results failed validation: nothing of the batch
    may be acted on and the device snapshot must be rebuilt (its commits
    for this batch are suspect). The Scheduler requeues the batch for the
    device."""

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
