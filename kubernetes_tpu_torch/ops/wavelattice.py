"""Wave-commit lattice: vectorized bulk pass + bounded conflict-resolution
(PyTorch port of ``kubernetes_tpu/ops/wavelattice.py::make_wave_kernel``).

  Stage A (fully vectorized, template granularity):
    * filter masks, score matrix, normalization per TEMPLATE [TPL, N];
    * topology-domain sums ONCE per (predicate, topology-key) pair [J, V]
      (the PairTable), not once per pod;
    * per-template top-M candidate nodes; per-pod candidate order =
      score-descending with per-pod random tie-noise (selectHost's uniform
      tie-break, generic_scheduler.go:235).

  Stage B (W waves, all-vectorized):
    every wave, each unplaced pod takes its best still-feasible candidate;
    conflicts are resolved batch-wide: per-node capacity by prefix-fit in
    pod order, per-(pair, domain) exclusivity by lowest pod index. Losers
    retry next wave against updated deltas; leftovers defer to the next
    batch. The lowest active pod always wins all its groups, so every wave
    commits ≥1 pod.

Where the two frameworks differ, and what this port does about it:

* Every ``jax.vmap`` (over templates, pairs, constraint slots) is a batch
  dimension written out; the ``fori_loop`` over waves is a Python loop.
* ``jax.lax.top_k`` breaks ties by lower index and ``torch.topk`` promises
  no order, so the top-M list is a stable descending sort sliced to M.
  ``jnp.argsort`` is stable: ``torch.argsort(stable=True)``. The
  ``associative_scan(maximum)`` is ``torch.cummax``; ``segment_sum`` /
  ``segment_max`` / ``segment_min`` are ``scatter_add_`` /
  ``scatter_reduce_``; ``jnp.interp`` is written out (``_interp``).
* JAX clamps out-of-range gathers and drops out-of-range (``mode="drop"``)
  scatter updates; torch raises (CPU) or asserts on the device (CUDA).
  Every gather index here is clamped as the reference clamps it, and
  every commit that the reference drops is instead masked: its row index
  is set to 0 and its update to zero, so it adds nothing.
* The JAX side runs with x64 off: index math here may run in int64, but
  every output and every snapshot field keeps the reference's dtype.
* The weighted score sum is XLA's dot, which on the CPU is a sequential
  fused multiply-add over the components; ``_dot_fma`` (``ops/lattice.py``)
  forms each step's product and sum in float64 and rounds once to float32,
  so equal scores stay equal across the two implementations and the
  candidate tie groups (exact float equality of ``top_v``) match. Elementwise
  chains XLA may contract differently; near-tie chosen nodes can then
  differ inside a ``TIE_EPS`` group, never outside one.
* The reference draws its tie noise inside the kernel
  (``jax.random.uniform(rng, (P, m_c), maxval=0.999)``). Here the noise is
  an input: ``WaveKernel.__call__`` draws it from a ``torch.Generator``,
  ``WaveKernel.with_noise`` takes the ``[P, m_c]`` float32 tensor (a test
  hands it the reference's own draw).
* Donation: the kernel updates the snapshot's occupancy tensors IN PLACE
  and returns the same tensors — the caller passes lease-private tensors
  (``SnapshotEncoder.donation_lease``), or a clone.
* The reference docstring says every wave's fit goes through the Pallas
  kernel; in its code only Stage A's ``fits0`` does, and the per-wave
  candidate-column check is a plain broadcast. This port does what the
  code does: ``use_pallas_fit`` routes ``fits0`` through
  ``fit_kernels.fit_mask`` (the CUDA kernel on the card).

The ``io_callback`` variant ``make_wave_kernel_cb_jit`` is
``make_wave_kernel_cb``: torch has no ``io_callback``, so the kernel hands
its fast index payload to a ``post(ticket, chosen, placed, deferred)``
callable right after its launches are queued, and the caller's ``post``
(``scheduler/wavepath.HostCallbackDelivery``) starts the device->host copy
and delivers the payload to ``ops/hostcallback`` from a thread that waits
on the copy's CUDA event.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, NamedTuple

import numpy as np
import torch

from .encoding import (
    DeviceSnapshot,
    ETERM_AFF_PREF,
    ETERM_AFF_REQ,
    ETERM_ANTI_PREF,
    ETERM_ANTI_REQ,
    RES_CPU,
    RES_MEM,
)
from .fit_kernels import fit_mask, fit_mask_plain
from .lattice import (
    Merge,
    SC_BALANCED,
    SC_LEAST_ALLOC,
    SC_MOST_ALLOC,
    SC_REQ_TO_CAP,
    _dot_fma,
    _image_counts,
    _image_locality,
    _label_cols,
    _node_affinity_required,
    _node_affinity_score,
    _prefer_avoid,
    _taints,
    run_local,
)
from .templates import PairTable, TemplateBatch

TIE_EPS = 1e-3
INT32_MAX = int(np.iinfo(np.int32).max)
_F32_EPS_SPACING = float(np.spacing(np.finfo(np.float32).eps))


class WaveResult(NamedTuple):
    chosen: Any  # [P] int32 node row, -1 = not placed
    placed: Any  # [P] bool
    deferred: Any  # [P] bool — feasible nodes existed but waves ran out
    feasible_count: Any  # [P] int32 base-feasible node count
    score: Any  # [P] float32
    resolvable_tpl: Any  # [TPL, N] bool — preemption candidates per template
    feasible_tpl: Any  # [TPL, N] bool — pre-commit filter verdicts


def _group_prefix_sums(groups, sort_key, values):
    """Exclusive prefix sums of `values` within equal-`groups` runs after
    sorting by sort_key (sort_key must sort group-contiguously, e.g.
    group*(P+1)+idx). Returns (order, exclusive_prefix[sorted order])."""
    order = torch.argsort(sort_key, stable=True)
    g = groups[order]
    v = values[order]
    cum = torch.cumsum(v, dim=0)
    excl_global = cum - v
    # group start position via running max over indices where a new group starts
    pos = torch.arange(g.shape[0], device=g.device)
    is_start = torch.ones_like(g, dtype=torch.bool)
    is_start[1:] = g[1:] != g[:-1]
    start_pos = torch.cummax(torch.where(is_start, pos, -1), dim=0).values
    base = excl_global[start_pos]
    return order, excl_global - base


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` written out: linear between the points,
    clamped to fp[0] / fp[-1] outside them."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= _F32_EPS_SPACING
    f = torch.where(
        dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df
    )
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _pair_verdicts(pt: PairTable, cnt, min_d, tot, dom):
    """Carry-dependent filter verdicts for every template given pair counts
    (cnt, dom ``[B, J, X]`` with B = 1 or TPL; min_d, tot ``[J]``). X is the
    column axis: all N node rows in Stage A, each template's M candidate
    columns in the waves, the pinned rows [P] for pinned pods. Returns
    (spread_bad, spread_pen, aff_ok, anti_bad, eterm_bad), each [TPL, X]."""
    TPL = pt.spr_pair.shape[0]
    J = pt.col.shape[0]
    cnt = cnt.expand(TPL, -1, -1)
    dom = dom.expand(TPL, -1, -1)
    rows = torch.arange(TPL, device=cnt.device)[:, None]

    def take(pairs):
        p = pairs.clamp(0, J - 1).long()
        return p, cnt[rows, p], dom[rows, p]  # [TPL, K], [TPL, K, X] x2

    # topology spread (hard: filter, soft: penalty)
    p, cnt_p, dom_p = take(pt.spr_pair)
    ok_pair = (pt.spr_pair >= 0)[..., None]
    haskey = dom_p >= 0
    md = min_d[p]
    m = torch.where(torch.isfinite(md), md, 0.0)[..., None]
    selfm = torch.where(pt.spr_self, 1.0, 0.0)[..., None]
    skewed = cnt_p + selfm - m > pt.spr_skew[..., None]
    hard = pt.spr_hard[..., None]
    bad = hard & (skewed | ~haskey)
    soft = torch.where(~hard, cnt_p, 0.0)
    spread_bad = (ok_pair & bad).any(dim=1)
    spread_pen = torch.where(ok_pair, soft, 0.0).sum(dim=1)

    # incoming required affinity (with the self-match carve-out)
    p, cnt_p, dom_p = take(pt.aff_pair)
    ok = (cnt_p > 0) | (
        (tot[p] == 0)[..., None] & pt.aff_self[..., None] & (dom_p >= 0)
    )
    aff_ok = torch.where((pt.aff_pair >= 0)[..., None], ok, True).all(dim=1)

    # incoming required anti-affinity
    p, cnt_p, dom_p = take(pt.anti_pair)
    bad = (dom_p >= 0) & (cnt_p > 0)
    anti_bad = ((pt.anti_pair >= 0)[..., None] & bad).any(dim=1)

    # existing pods' required anti-affinity terms matching the template
    et_rel = pt.etm_match & (pt.kind == ETERM_ANTI_REQ)[None, :]  # [TPL, J]
    eterm_bad = (et_rel[..., None] & (dom >= 0) & (cnt > 0)).any(dim=1)
    return spread_bad, spread_pen, aff_ok, anti_bad, eterm_bad


DEFAULT_RTC_SHAPE = ((0.0, 0.0), (100.0, 10.0))


class WaveKernel:
    """The wave kernel for the given static capacities (the reference's
    ``make_wave_kernel`` closure). Call it as
    ``kernel(snap, tb, pt, weights, rng)`` with a ``torch.Generator`` on
    the snapshot's device, or ``kernel.with_noise(snap, tb, pt, weights,
    noise)`` with the ``[P, min(m_cand, N)]`` float32 tie noise in
    [0, 0.999). Both return ``(snap, WaveResult)``; ``snap``'s occupancy
    tensors are updated in place (donation).

    has_pinned=False leaves out the per-wave pinned-row plan (the [J, P]
    pair gathers + [TPL, J, P] verdicts), whose results an all-unpinned
    batch would discard.

    rtc_shape: the RequestedToCapacityRatio piecewise points
    ((utilization%, score 0..10), ...), interpolated on the device.

    use_pallas_fit (name kept for parity with the reference) routes Stage
    A's fit mask through ``fit_kernels.fit_mask`` — the hand-written CUDA
    kernel for CUDA tensors; False uses the plain broadcast.

    score_refresh re-evaluates the RESOURCE score components at each pod's
    candidate nodes every wave so later waves see in-batch commits in
    their packing decisions; non-resource components stay Stage-A
    static."""

    def __init__(
        self,
        v_cap: int,
        m_cand: int = 128,
        n_waves: int = 8,
        hard_pod_affinity_weight: float = 1.0,
        use_pallas_fit: bool = True,
        score_refresh: bool = True,
        rtc_shape: tuple = DEFAULT_RTC_SHAPE,
        has_pinned: bool = True,
    ):
        self.v_cap = v_cap
        self.m_cand = m_cand
        self.n_waves = n_waves
        self.hard_pod_affinity_weight = float(hard_pod_affinity_weight)
        self.fit = fit_mask if use_pallas_fit else fit_mask_plain
        self.score_refresh = score_refresh
        self.rtc_shape = tuple(rtc_shape)
        self.has_pinned = has_pinned

    def __call__(self, snap, tb, pt, weights, rng: torch.Generator):
        P = tb.pod_tpl.shape[0]
        m_c = min(self.m_cand, snap.valid.shape[0])
        noise = torch.rand(
            (P, m_c), generator=rng, device=snap.valid.device,
            dtype=torch.float32,
        ) * 0.999
        return self.with_noise(snap, tb, pt, weights, noise)

    def with_noise(
        self,
        snap: DeviceSnapshot,
        tb: TemplateBatch,
        pt: PairTable,
        weights,
        noise: torch.Tensor,
    ):
        v_cap = self.v_cap
        dev = snap.valid.device
        f32 = torch.float32
        tpl = tb.tpl
        n = snap.valid.shape[0]
        TPL = tpl.valid.shape[0]
        P = tb.pod_tpl.shape[0]
        J = pt.col.shape[0]
        m_c = min(self.m_cand, n)  # candidate list cannot exceed node capacity
        weights = torch.as_tensor(weights, dtype=f32).to(dev)
        if tuple(noise.shape) != (P, m_c):
            raise ValueError(f"tie noise is {tuple(noise.shape)}, want {(P, m_c)}")

        # ================= Stage A: per-template statics =================
        st = run_local(self._stage_a(snap, tpl, pt, weights, m_c, None))
        top_i, feasible0 = st["top_i"], st["feasible0"]
        t_of, pinned, pin_rows = _pod_rows(tb, TPL, n)
        pin_feas = feasible0[t_of, pin_rows]
        cand_slot, cand_nodes, cand_valid = _candidates(
            tb, st["top_v"], top_i, noise, t_of, pinned, pin_rows, pin_feas, n, m_c
        )

        # ---- per-wave candidate-column statics (hoisted gathers) ----
        free0, dom_j, cnt0 = st["free0"], st["dom_j"], st["cnt0"]
        c = SimpleNamespace(
            tb=tb, pt=pt, weights=weights, n=n, m_c=m_c, t_of=t_of,
            pinned=pinned, top_i=top_i, cand_slot=cand_slot,
            cand_nodes=cand_nodes, cand_valid=cand_valid,
            base_dom=st["base_dom"], present_dom=st["present_dom"],
            tot0=st["tot0"], rtc=st["rtc_fn"],
        )
        c.static_ok_c = st["static_ok"].gather(1, top_i)  # [TPL, M]
        c.free0_cols = free0[top_i]  # [TPL, M, R]
        c.port0_cols = snap.port_counts[top_i]  # [TPL, M, PV]
        dom_jc = dom_j[:, top_i]  # [J, TPL, M]
        c.dom_cols = dom_jc.permute(1, 0, 2)  # [TPL, J, M]
        c.cnt0_cols = cnt0[:, top_i].permute(1, 0, 2)  # [TPL, J, M]
        c.dom_cols_flat = dom_jc.reshape(J, TPL * m_c).clamp(0, v_cap - 1).long()
        if self.has_pinned:
            c.dom_pin = dom_j[:, pin_rows]  # [J, P]
            c.dom_pin_flat = c.dom_pin.clamp(0, v_cap - 1).long()
            c.cnt0_pin = cnt0[:, pin_rows]  # [J, P]
            c.pin_req = tpl.req[t_of]  # [P, R]
            c.pin_ports = tpl.port_mask[t_of]  # [P, PV]

        if self.score_refresh:
            # static pieces of the per-wave candidate re-score: the
            # NON-resource score residual at each candidate, plus the
            # batch-start nonzero/alloc cpu+mem columns there
            w_res = (
                weights[SC_LEAST_ALLOC] * st["least"]
                + weights[SC_MOST_ALLOC] * st["most"]
                + weights[SC_BALANCED] * st["balanced"]
                + weights[SC_REQ_TO_CAP] * st["rtc"]
            )  # [TPL, N]
            c.cand_resid = (st["total_score"] - w_res)[t_of].gather(1, cand_nodes)  # [P, M]
            c.alloc_cpu_c = snap.allocatable[:, RES_CPU][cand_nodes].to(f32).clamp(min=1.0)
            c.alloc_mem_c = snap.allocatable[:, RES_MEM][cand_nodes].to(f32).clamp(min=1.0)
            c.nz_cpu0_c = snap.nonzero_req[:, RES_CPU][cand_nodes]
            c.nz_mem0_c = snap.nonzero_req[:, RES_MEM][cand_nodes]
            c.pod_nz_cpu = tpl.nonzero_req[:, RES_CPU][t_of][:, None]
            c.pod_nz_mem = tpl.nonzero_req[:, RES_MEM][t_of][:, None]

        # ================= Stage B: waves =================
        c.req_d = torch.zeros_like(snap.requested)
        c.port_d = torch.zeros_like(snap.port_counts)
        c.nz2_d = torch.zeros((n, 2), dtype=snap.nonzero_req.dtype, device=dev)
        rows = _AllRows(free0, snap.port_counts, dom_j, pin_rows)
        placed, chosen, req_t, ports_t = self._waves(c, rows)

        # ================= finalize: commit occupancy to snapshot ==========
        # Every field the host's add_pod touches is committed here (incl.
        # prio_req by priority band), IN PLACE, so the host replay can skip
        # the dirty-row re-upload (encoding.add_pod device_synced=True).
        _commit(
            snap, torch.where(placed, chosen, 0), placed[:, None], tb, t_of,
            req_t, ports_t,
        )
        score_at = st["total_score"][t_of, chosen.clamp(0, n - 1)]
        return snap, _result(
            tb, t_of, pinned, pin_feas, st["feas_cnt_tpl"], placed, chosen,
            score_at, st["resolvable_tpl"], feasible0,
        )

    def _stage_a(self, snap, tpl, pt, weights, m_c: int, shard=None):
        """Stage A on one block of node rows: the whole snapshot on one
        device (shard None), or one shard's rows whose first global row is
        `shard` (``parallel/sharded.ShardedWaveKernel``). A generator: it yields
        the merges across shards it needs as :class:`~.lattice.Merge`
        requests — the per-(pair, domain) sums and their presence, the
        normalizations' maxima with the feasible counts, and the top-M
        candidates — and takes back the merged tensors; ``run_local``
        answers every merge with its own value on one device. Returns a
        dict of the block's Stage-A tensors, with ``top_v``/``top_i``
        (global rows) merged.

        The domain sums are float32 (``w_j`` of an eterm pair is the float
        ``eterm_w``); partial sums over shards add up to exactly the one
        device's sum as long as every weight is integral and every sum
        stays under 2**24, which the encoder's counts and integer term
        weights keep."""
        v_cap = self.v_cap
        dev = snap.valid.device
        f32 = torch.float32
        TPL = tpl.valid.shape[0]
        J = pt.col.shape[0]

        counts = None
        if shard is not None:
            # the image spread is over every node
            n_valid, have = _image_counts(snap)
            got = yield {"n_valid": Merge("sum", n_valid), "have": Merge("sum", have)}
            counts = (got["n_valid"], got["have"])
        ns_aff = _node_affinity_required(snap, tpl, shard or 0)  # [TPL, N]
        taint_ok, prefer_cnt = _taints(snap, tpl)
        unsched_ok = ~snap.unschedulable[None, :] | tpl.tolerates_unschedulable[:, None]
        static_ok = snap.valid[None, :] & ns_aff & taint_ok & unsched_ok
        aff_score = _node_affinity_score(snap, tpl)
        img = _image_locality(snap, tpl, counts)
        avoid = _prefer_avoid(snap, tpl)

        free0 = snap.allocatable - snap.requested  # [N, R]
        fits0 = self.fit(tpl.req.contiguous(), free0.contiguous())  # [TPL, N]
        ports0 = (
            tpl.port_mask[:, None, :] & (snap.port_counts[None] > 0)
        ).any(dim=-1)  # [TPL, N]

        # ---- pair domain structure [J, N] ----
        col = pt.col.clamp(min=0).long()
        sidv = snap.sel_counts.T[col.clamp(max=snap.sel_counts.shape[1] - 1)]
        etv = snap.eterm_w.T[col.clamp(max=snap.eterm_w.shape[1] - 1)]
        w_j = torch.where(pt.is_eterm[:, None], etv, sidv.to(f32))
        dom_j, _ = _label_cols(snap, pt.key)
        e = pt.elig_tpl
        elig = torch.where(
            (e >= 0)[:, None], ns_aff[e.clamp(0, TPL - 1).long()], True
        )
        elig_j = elig & snap.valid[None, :] & (dom_j >= 0)

        # per-(pair, domain) sums; the spare segment v_cap takes the
        # ineligible rows the reference drops
        seg = torch.where(elig_j, dom_j, v_cap).long()
        base_dom = torch.zeros((J, v_cap + 1), dtype=f32, device=dev).scatter_add_(
            1, seg, torch.where(elig_j, w_j, 0.0)
        )[:, :v_cap]  # [J, V]
        present_dom = torch.zeros((J, v_cap + 1), dtype=torch.int32, device=dev).scatter_reduce_(
            1, seg, elig_j.to(torch.int32), "amax"
        )[:, :v_cap] > 0  # [J, V] — wave-invariant
        # domain ids are global: the shards' partial sums add up
        got = yield {
            "base_dom": Merge("sum", base_dom), "present_dom": Merge("any", present_dom),
        }
        base_dom, present_dom = got["base_dom"], got["present_dom"]
        cnt0 = torch.where(
            dom_j >= 0, base_dom.gather(1, dom_j.clamp(0, v_cap - 1).long()), 0.0
        )  # [J, N]
        min0 = torch.where(present_dom, base_dom, float("inf")).amin(dim=1)
        tot0 = base_dom.sum(dim=1)

        spread_bad0, spread_pen0, aff_ok0, anti_bad0, eterm_bad0 = _pair_verdicts(
            pt, cnt0[None], min0, tot0, dom_j[None]
        )
        feasible0 = (
            static_ok & fits0 & ~ports0 & ~spread_bad0 & aff_ok0 & ~anti_bad0
            & ~eterm_bad0
        )  # [TPL, N]
        resolvable_tpl = static_ok & ~feasible0
        feas_cnt_tpl = feasible0.to(torch.int32).sum(dim=1, dtype=torch.int32)

        # ---- scores [TPL, N] ----
        # resource scores only read the cpu/mem columns: the two [TPL, N]
        # fraction planes directly, no [TPL, N, R] broadcast
        def _frac(c):
            a = snap.allocatable[:, c].to(f32).clamp(min=1.0)[None]
            u = (snap.nonzero_req[:, c][None] + tpl.nonzero_req[:, c][:, None]).to(f32)
            return (u / a).clamp(0.0, 1.0)

        cpu_f, mem_f = _frac(RES_CPU), _frac(RES_MEM)
        least = ((1.0 - cpu_f) + (1.0 - mem_f)) * 50.0
        most = (cpu_f + mem_f) * 50.0
        balanced = (1.0 - (cpu_f - mem_f).abs()) * 100.0
        # piecewise shape over mean utilization%, scaled 0..100 like the
        # host plugin (score 0..10 * 10)
        rtc_xs = torch.tensor([p[0] for p in self.rtc_shape], dtype=f32, device=dev)
        rtc_ys = torch.tensor([p[1] for p in self.rtc_shape], dtype=f32, device=dev)

        def _rtc(cf, mf):
            return _interp((cf + mf) * 50.0, rtc_xs, rtc_ys) * 10.0

        rtc = _rtc(cpu_f, mem_f)

        # interpod score: existing pods' terms + incoming preferred terms
        sgn = torch.zeros(J, dtype=f32, device=dev)
        for kind, val in (
            (ETERM_AFF_REQ, self.hard_pod_affinity_weight),
            (ETERM_AFF_PREF, 1.0),
            (ETERM_ANTI_PREF, -1.0),
        ):
            sgn = torch.where(pt.kind == kind, val, sgn)
        ip_et = _dot_fma(pt.etm_match.to(f32) * sgn[None, :], cnt0)  # [TPL, N]
        pref_p = pt.pref_pair.clamp(0, J - 1).long()  # [TPL, W]
        ip_pref = torch.where(
            (pt.pref_pair >= 0)[..., None], pt.pref_w[..., None] * cnt0[pref_p], 0.0
        ).sum(dim=1)
        ip = ip_et + ip_pref  # [TPL, N]

        def masked_max(x):
            return torch.where(feasible0, x, -float("inf")).amax(dim=1, keepdim=True)

        def norm_max(x, mx):
            safe = torch.where(torch.isfinite(mx) & (mx > 0), mx, 1.0)
            return (x / safe * 100.0).clamp(0.0, 100.0)

        def norm_invert(x, mx):
            ok = torch.isfinite(mx) & (mx > 0)
            safe = torch.where(ok, mx, 1.0)
            return torch.where(ok, (safe - x) / safe * 100.0, 100.0)

        ip_mx = torch.where(feasible0, ip.abs(), 0.0).amax(dim=1, keepdim=True)

        # DefaultPodTopologySpread: same-service pods per node through the
        # service-derived sel_counts columns; MAX over matching services
        svc_cnt = torch.where(
            tpl.match_svc[:, None, :], snap.sel_counts[None].to(f32), 0.0
        ).amax(dim=-1)  # [TPL, N]

        cost_col = snap.cost_milli.to(f32)[None, :].expand_as(least)
        energy_col = snap.energy_milli.to(f32)[None, :].expand_as(least)
        # every normalization divides by a maximum over all N nodes
        got = yield {
            "ip_mx": Merge("max", ip_mx),
            "aff": Merge("max", masked_max(aff_score)),
            "prefer": Merge("max", masked_max(prefer_cnt)),
            "spread": Merge("max", masked_max(spread_pen0)),
            "svc": Merge("max", masked_max(svc_cnt)),
            "cost": Merge("max", masked_max(cost_col)),
            "energy": Merge("max", masked_max(energy_col)),
            "feas_cnt": Merge("sum", feas_cnt_tpl),
        }
        ip_mx = got["ip_mx"]
        ip_norm = torch.where(ip_mx > 0, ip / ip_mx * 100.0, 0.0)
        comps = torch.stack(
            [
                least,
                most,
                balanced,
                rtc,
                norm_max(aff_score, got["aff"]),
                norm_invert(prefer_cnt, got["prefer"]),
                img,
                avoid,
                norm_invert(spread_pen0, got["spread"]),
                ip_norm,
                norm_invert(svc_cnt, got["svc"]),
                norm_invert(cost_col, got["cost"]),
                norm_invert(energy_col, got["energy"]),
            ]
        )  # [K, TPL, N]
        total_score = _dot_fma(weights, comps)  # [TPL, N]

        # ---- top-M candidates per template (stable: ties by lower index) ----
        masked = torch.where(feasible0, total_score, -float("inf"))
        top_v, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
        k = min(m_c, masked.shape[1])  # a shard may hold fewer rows than M
        top_v, top_i = top_v[:, :k], top_i[:, :k]  # [TPL, M]
        if shard:
            top_i = top_i + shard
        top_v, top_i = (yield {"top": Merge("top", (top_v, top_i), m_c)})["top"]
        return {
            "static_ok": static_ok, "free0": free0, "dom_j": dom_j, "cnt0": cnt0,
            "feasible0": feasible0, "resolvable_tpl": resolvable_tpl,
            "feas_cnt_tpl": got["feas_cnt"], "total_score": total_score,
            "least": least, "most": most, "balanced": balanced, "rtc": rtc,
            "rtc_fn": _rtc, "base_dom": base_dom, "present_dom": present_dom,
            "tot0": tot0, "top_v": top_v, "top_i": top_i,
        }

    def _waves(self, c, rows):
        """Stage B on the merged candidates: `c` holds the batch's pod-side
        tensors, the [TPL, M] candidate-column statics and the deltas;
        `rows` answers the loop's reads of node rows outside those columns
        (``_AllRows`` on one device, ``parallel/sharded._ColumnRows`` on a
        mesh). Returns (placed, chosen, req_t, ports_t)."""
        v_cap = self.v_cap
        tb, pt, weights, t_of = c.tb, c.pt, c.weights, c.t_of
        tpl = tb.tpl
        dev = t_of.device
        f32 = torch.float32
        n, m_c = c.n, c.m_c
        TPL = tpl.valid.shape[0]
        P = tb.pod_tpl.shape[0]
        J = pt.col.shape[0]
        top_i, cand_slot, cand_nodes = c.top_i, c.cand_slot, c.cand_nodes
        cand_valid, pinned = c.cand_valid, c.pinned
        req_d, port_d, nz2_d = c.req_d, c.port_d, c.nz2_d
        base_dom, present_dom = c.base_dom, c.present_dom

        # which pods participate in pair exclusivity (contributor or
        # hard-checker), per pair
        def scatter_pairs(pairs, extra_mask=None):
            m = pairs >= 0 if extra_mask is None else (pairs >= 0) & extra_mask
            out = torch.zeros((TPL, J), dtype=torch.int32, device=dev)
            out.scatter_reduce_(
                1, pairs.clamp(0, J - 1).long(), m.to(torch.int32), "amax"
            )
            return out > 0

        checks = scatter_pairs(pt.spr_pair, pt.spr_hard)
        checks = checks | scatter_pairs(pt.anti_pair)
        checks = checks | (pt.etm_match & (pt.kind == ETERM_ANTI_REQ)[None, :])
        # Exclusivity is only needed for pairs some template HARD-checks;
        # pure-affinity pairs are monotone under additions, so their
        # contributors commit freely.
        needs_excl = checks.any(dim=0)  # [J]
        participates = (checks | (pt.contrib != 0)) & needs_excl[None, :]
        is_contrib_tpl = pt.contrib != 0  # [TPL, J]
        uses_carveout = scatter_pairs(pt.aff_pair, pt.aff_self)

        # resource matrix for prefix-fit: requests ⧺ port usage (capacity 1)
        req_ext_tpl = torch.cat(
            [tpl.req.to(torch.int32), tpl.port_mask.to(torch.int32)], dim=1
        )  # [TPL, R+PV]
        req_t = tpl.req[t_of]  # [P, R]
        ports_t = tpl.port_mask[t_of].to(torch.int32)  # [P, PV]
        nz2_t = torch.stack(
            [tpl.nonzero_req[:, RES_CPU], tpl.nonzero_req[:, RES_MEM]], dim=1
        )[t_of]  # [P, 2]
        req_ext_t = req_ext_tpl[t_of]  # [P, R+PV]
        contrib_t = pt.contrib[t_of]  # [P, J]
        pods = torch.arange(P, device=dev)
        pairs_row = torch.arange(J, device=dev)[None, :]
        pod_idx_mat = pods[:, None].expand(P, J).reshape(-1)
        dump = J * (v_cap + 2)

        placed = torch.zeros(P, dtype=torch.bool, device=dev)
        chosen = torch.full((P,), -1, dtype=torch.int64, device=dev)
        dom_d = torch.zeros((J, v_cap), dtype=f32, device=dev)
        for _ in range(self.n_waves):
            rows.wave(req_d, port_d)
            # ---- candidate-column re-checks: [TPL, M], never [TPL, N] ----
            free_c = c.free0_cols - req_d[top_i]  # [TPL, M, R]
            fits_w_c = (
                (tpl.req[:, None, :] == 0) | (tpl.req[:, None, :] <= free_c)
            ).all(dim=-1)  # [TPL, M]
            ports_w_c = (
                tpl.port_mask[:, None, :] & ((c.port0_cols + port_d[top_i]) > 0)
            ).any(dim=-1)  # [TPL, M]
            dd = dom_d.gather(1, c.dom_cols_flat).reshape(J, TPL, m_c)
            cnt_w_cols = c.cnt0_cols + torch.where(
                c.dom_cols >= 0, dd.permute(1, 0, 2), 0.0
            )  # [TPL, J, M]
            sums_w = base_dom + dom_d  # [J, V]
            min_w = torch.where(present_dom, sums_w, float("inf")).amin(dim=1)
            tot_w = c.tot0 + dom_d.sum(dim=1)

            sb, _, ao, ab, eb = _pair_verdicts(pt, cnt_w_cols, min_w, tot_w, c.dom_cols)
            wave_feas_c = (
                c.static_ok_c & fits_w_c & ~ports_w_c & ~sb & ao & ~ab & ~eb
            )  # [TPL, M]

            cand_feas = wave_feas_c[t_of[:, None], cand_slot] & cand_valid
            if self.has_pinned:
                # pinned pods: live resource/port fit at the pinned row +
                # live pair verdicts there (the row may be outside top-M)
                pin_free = rows.pin_free()  # [P, R]
                pin_fit = ((c.pin_req == 0) | (c.pin_req <= pin_free)).all(dim=-1)
                pin_port_bad = (c.pin_ports & (rows.pin_ports_used() > 0)).any(dim=-1)
                dd_pin = dom_d.gather(1, c.dom_pin_flat)
                cnt_pin = c.cnt0_pin + torch.where(c.dom_pin >= 0, dd_pin, 0.0)
                sb_p, _, ao_p, ab_p, eb_p = _pair_verdicts(
                    pt, cnt_pin[None], min_w, tot_w, c.dom_pin[None]
                )  # each [TPL, P]
                pair_ok_pin = (~sb_p & ao_p & ~ab_p & ~eb_p)[t_of, pods]  # [P]
                pin_ok_w = pin_fit & ~pin_port_bad & pair_ok_pin
                # replace (not AND): a pinned pod's single candidate is the
                # pinned row, whose verdict is pin_ok_w
                cand_feas = torch.where(
                    pinned[:, None], cand_valid & pin_ok_w[:, None], cand_feas
                )  # [P, M]
            if self.score_refresh:
                # re-evaluate the resource scores at the candidates with
                # this wave's committed occupancy; the candidate list is
                # pre-shuffled within equal-static-score groups, so a
                # plain argmax (first maximum) inherits the tie-break
                cpu_f_c = (
                    (c.nz_cpu0_c + nz2_d[:, 0][cand_nodes] + c.pod_nz_cpu).to(f32)
                    / c.alloc_cpu_c
                ).clamp(0.0, 1.0)
                mem_f_c = (
                    (c.nz_mem0_c + nz2_d[:, 1][cand_nodes] + c.pod_nz_mem).to(f32)
                    / c.alloc_mem_c
                ).clamp(0.0, 1.0)
                res_c = (
                    weights[SC_LEAST_ALLOC]
                    * (((1.0 - cpu_f_c) + (1.0 - mem_f_c)) * 50.0)
                    + weights[SC_MOST_ALLOC] * ((cpu_f_c + mem_f_c) * 50.0)
                    + weights[SC_BALANCED]
                    * ((1.0 - (cpu_f_c - mem_f_c).abs()) * 100.0)
                    + weights[SC_REQ_TO_CAP] * c.rtc(cpu_f_c, mem_f_c)
                )
                score_c = torch.where(
                    cand_feas, c.cand_resid + res_c, -float("inf")
                )  # [P, M]
                first = score_c.argmax(dim=1)
            else:
                first = cand_feas.to(torch.uint8).argmax(dim=1)
            has = cand_feas.any(dim=1)
            cand_n = cand_nodes[pods, first]
            active = tb.pod_valid & ~placed & has

            # -- capacity prefix-fit in pod order --
            grp = torch.where(active, cand_n, n)
            sort_key = grp * (P + 1) + pods
            vals = req_ext_t * active[:, None].to(torch.int32)
            order_c, excl = _group_prefix_sums(grp, sort_key, vals)
            # free resources and port room [P, R+PV] at each pod's
            # candidate, in the prefix-sum order
            free_sorted = rows.free_ext_sorted(cand_n, first, order_c)
            req_sorted = req_ext_t[order_c]
            fit_sorted = (excl + req_sorted <= free_sorted).all(dim=1)
            fit_ok = torch.empty(P, dtype=torch.bool, device=dev)
            fit_ok[order_c] = fit_sorted

            # -- (pair, domain) exclusivity --
            pod_dom = rows.dom_at(cand_n, first)  # [P, J] domain of candidate per pair
            carve = (
                uses_carveout[t_of] & (tot_w == 0)[None, :] & active[:, None]
            )
            # carveout claims are exclusive regardless of the needs_excl gate
            part = (participates[t_of] | carve) & active[:, None]  # [P, J]
            key_pd = torch.where(
                carve,
                pairs_row * (v_cap + 2) + v_cap + 1,
                pairs_row * (v_cap + 2) + pod_dom.clamp(0, v_cap - 1).long(),
            )
            part = part & ((pod_dom >= 0) | carve)
            is_contrib = (is_contrib_tpl[t_of] | carve) & part  # [P, J]
            flat_key = torch.where(part, key_pd, dump).reshape(-1)
            flat_key_c = torch.where(is_contrib, key_pd, dump).reshape(-1)
            nseg = dump + 1
            min_all = torch.full((nseg,), INT32_MAX, dtype=torch.int64, device=dev)
            min_all.scatter_reduce_(0, flat_key, pod_idx_mat, "amin")
            min_con = torch.full((nseg,), INT32_MAX, dtype=torch.int64, device=dev)
            min_con.scatter_reduce_(0, flat_key_c, pod_idx_mat, "amin")
            # contributor commits iff it is the group's lowest participant;
            # checker-only pods commit iff no contributor is committing in
            # their group this wave (group min is a checker)
            g_all = min_all[flat_key].reshape(P, J)
            g_con = min_con[flat_key].reshape(P, J)
            # serial-order guard for the carveout: block the claim this wave
            # when any lower-indexed active contributor exists pair-wide
            contrib_any = is_contrib_tpl[t_of] & active[:, None] & ~carve
            pair_key = torch.where(contrib_any, pairs_row, J).reshape(-1)
            min_contrib_pair = torch.full(
                (J + 1,), INT32_MAX, dtype=torch.int64, device=dev
            ).scatter_reduce_(0, pair_key, pod_idx_mat, "amin")[:J]
            carve_allowed = pods[:, None] < min_contrib_pair[None, :]  # [P, J]
            ok_pair = torch.where(
                is_contrib, g_all == pod_idx_mat.reshape(P, J), g_con > g_all
            ) & (~carve | carve_allowed)
            dom_ok = (ok_pair | ~part).all(dim=1)

            commit = active & fit_ok & dom_ok
            # the reference drops uncommitted rows (index n, mode="drop");
            # here they add zero to row 0
            ci = torch.where(commit, cand_n, 0)
            cm = commit[:, None]
            req_d.index_add_(0, ci, req_t * cm)
            port_d.index_add_(0, ci, ports_t * cm)
            nz2_d.index_add_(0, ci, nz2_t * cm)
            contrib_p = contrib_t * cm  # [P, J]
            dd_ok = (pod_dom >= 0) & (contrib_p != 0)
            dd_key = torch.where(
                dd_ok, pairs_row * v_cap + pod_dom.clamp(0, v_cap - 1).long(), 0
            ).reshape(-1)
            dom_d.view(-1).index_add_(
                0, dd_key, torch.where(dd_ok, contrib_p, 0.0).reshape(-1)
            )
            placed = placed | commit
            chosen = torch.where(commit, cand_n, chosen)
        return placed, chosen, req_t, ports_t


class _AllRows:
    """The wave loop's reads of node rows on one device, where Stage A's
    [N, ...] tensors are at hand: each wave's live free matrix once, and
    plain row gathers from it."""

    def __init__(self, free0, port_counts, dom_j, pin_rows):
        self.free0, self.port_counts = free0, port_counts
        self.dom_j, self.pin_rows = dom_j, pin_rows

    def wave(self, req_d, port_d):
        self.free_d = self.free0 - req_d  # [N, R] (prefix-fit still needs full N)
        self.port_d = port_d

    def pin_free(self):
        return self.free_d[self.pin_rows]

    def pin_ports_used(self):
        return (self.port_counts + self.port_d)[self.pin_rows]

    def free_ext_sorted(self, cand_n, first, order_c):
        free_ext = torch.cat(
            [self.free_d, 1 - (self.port_counts + self.port_d).clamp(max=1)], dim=1
        )  # [N, R+PV]
        return free_ext[cand_n[order_c]]

    def dom_at(self, cand_n, first):
        return self.dom_j[:, cand_n].T


def _pod_rows(tb: TemplateBatch, TPL: int, n: int):
    """Each pod's template, whether it is pinned, and its pinned row."""
    t_of = tb.pod_tpl.clamp(0, TPL - 1).long()  # [P]
    pinned = tb.pod_name_row >= 0
    pin_rows = tb.pod_name_row.clamp(0, n - 1).long()  # [P]
    return t_of, pinned, pin_rows


def _candidates(tb, top_v, top_i, noise, t_of, pinned, pin_rows, pin_feas, n, m_c):
    """Per-pod candidate order over the template's top-M list: by score
    group, uniformly random within a group (the tie noise); a pinned pod's
    one candidate is its pinned row. Returns (cand_slot, cand_nodes,
    cand_valid), each [P, M]."""
    dev = top_v.device
    TPL = top_v.shape[0]
    # top_v is sorted descending; equal-score runs form groups. Order
    # candidates by score-group, uniformly random within a group.
    steps = torch.zeros((TPL, m_c), dtype=torch.float32, device=dev)
    steps[:, 1:] = (top_v[:, 1:] != top_v[:, :-1]).to(torch.float32)
    grp_id = torch.cumsum(steps, dim=1)  # [TPL, M]
    pod_v = top_v[t_of]  # [P, M]
    order = torch.argsort(grp_id[t_of] + noise, dim=1, stable=True)  # [P, M]
    # order doubles as the SLOT index into the template's top-M column
    # list: per-wave feasibility is evaluated once per (template,
    # column) at [TPL, M] and pods read it through cand_slot
    cand_slot = order
    cand_nodes = top_i[t_of].gather(1, order)  # [P, M]
    cand_valid = torch.isfinite(pod_v.gather(1, order))
    # pinned pods: single candidate = the pinned row (still filter-checked)
    slot0 = (torch.arange(m_c, device=dev) == 0)[None, :]
    cand_nodes = torch.where(
        pinned[:, None], torch.where(slot0, pin_rows[:, None], 0), cand_nodes
    )
    cand_slot = torch.where(pinned[:, None], 0, cand_slot)
    cand_valid = torch.where(
        pinned[:, None], slot0 & pin_feas[:, None], cand_valid
    )
    # spec.nodeName names a node the cache doesn't know (row -2): the
    # NodeName filter fails everywhere -> unschedulable, never placed
    cand_valid = cand_valid & (tb.pod_name_row != -2)[:, None]
    cand_nodes = cand_nodes.clamp(0, n - 1)
    return cand_slot, cand_nodes, cand_valid


def _commit(snap, ci, pm, tb, t_of, req_t, ports_t):
    """Add the placed pods (`pm` [P, 1]) into the snapshot's occupancy at
    rows `ci`, in place: every field the host's add_pod touches."""
    tpl = tb.tpl
    n = snap.prio_req.shape[0]
    pb, r = snap.prio_req.shape[1], snap.prio_req.shape[2]
    band = tb.pod_band.clamp(0, pb - 1).long()
    snap.requested.index_add_(0, ci, req_t * pm)
    snap.nonzero_req.index_add_(0, ci, tpl.nonzero_req[t_of] * pm)
    snap.sel_counts.index_add_(0, ci, tpl.match_sel[t_of].to(torch.int32) * pm)
    snap.eterm_w.index_add_(0, ci, tpl.eterm_add[t_of] * pm)
    snap.port_counts.index_add_(0, ci, ports_t * pm)
    snap.prio_req.view(n * pb, r).index_add_(0, ci * pb + band, req_t * pm)


def _result(tb, t_of, pinned, pin_feas, feas_cnt_tpl, placed, chosen, score_at,
            resolvable_tpl, feasible_tpl) -> WaveResult:
    """The kernel's outputs from the wave loop's placements; `score_at` is
    each pod's template score at its chosen row."""
    feas_cnt = torch.where(tb.pod_valid, feas_cnt_tpl[t_of], 0)
    feas_cnt = torch.where(
        pinned, (pin_feas & tb.pod_valid).to(torch.int32), feas_cnt
    )
    # unknown pinned node: zero feasible so the pod FAILS instead of
    # deferring into a requeue hot-loop
    feas_cnt = torch.where(tb.pod_name_row == -2, 0, feas_cnt)
    score_out = torch.where(placed, score_at, -float("inf"))
    deferred = tb.pod_valid & ~placed & (feas_cnt > 0)
    return WaveResult(
        chosen=torch.where(placed, chosen, -1).to(torch.int32),
        placed=placed,
        deferred=deferred,
        feasible_count=feas_cnt.to(torch.int32),
        score=score_out,
        resolvable_tpl=resolvable_tpl,
        feasible_tpl=feasible_tpl,
    )


def make_wave_kernel(
    v_cap: int,
    m_cand: int = 128,
    n_waves: int = 8,
    hard_pod_affinity_weight: float = 1.0,
    use_pallas_fit: bool = True,
    score_refresh: bool = True,
    rtc_shape: tuple = DEFAULT_RTC_SHAPE,
    has_pinned: bool = True,
) -> WaveKernel:
    """The reference's factory signature; see :class:`WaveKernel`."""
    return WaveKernel(
        v_cap, m_cand, n_waves, hard_pod_affinity_weight, use_pallas_fit,
        score_refresh, rtc_shape, has_pinned,
    )


class WaveKernelCB:
    """The ``host_callback_binds`` variant of the wave kernel (the
    reference's ``make_wave_kernel_cb_jit``): identical compute, plus the
    hand-off of the fast index payload (chosen/placed/deferred) under a
    per-launch ``ticket``. Where the reference's ``io_callback`` makes the
    device post the payload to ``ops/hostcallback`` when the kernel
    resolves, here ``post(ticket, chosen, placed, deferred)`` is called
    with the output tensors once the kernel's launches are queued; the
    caller's ``post`` must start their device->host copy and arrange for
    ``hostcallback.deliver`` once it lands. The full WaveResult is still
    returned: the trailing bulk validation and the failure paths
    (resolvable_tpl) read it the ordinary way."""

    def __init__(self, base: WaveKernel):
        self.base = base

    def with_noise(self, snap, tb, pt, weights, noise, ticket, post):
        new_snap, res = self.base.with_noise(snap, tb, pt, weights, noise)
        post(ticket, res.chosen, res.placed, res.deferred)
        return new_snap, res


def make_wave_kernel_cb(
    v_cap: int,
    m_cand: int = 128,
    n_waves: int = 8,
    hard_pod_affinity_weight: float = 1.0,
    use_pallas_fit: bool = True,
    score_refresh: bool = True,
    rtc_shape: tuple = DEFAULT_RTC_SHAPE,
    has_pinned: bool = True,
) -> WaveKernelCB:
    """The reference's ``make_wave_kernel_cb_jit`` signature; see
    :class:`WaveKernelCB`."""
    return WaveKernelCB(
        make_wave_kernel(
            v_cap, m_cand, n_waves, hard_pod_affinity_weight,
            use_pallas_fit, score_refresh, rtc_shape, has_pinned,
        )
    )
