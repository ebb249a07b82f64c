"""The device-facing half of the scheduler's wave path, as plain functions.

Counterparts in ``kubernetes_tpu/scheduler/scheduler.py``:

* ``batch_waves`` — ``Scheduler._batch_waves`` (:1721): the wave count and
  whether the batch has hard pairs, from the templates present in it.
* ``launch_wave_kernel`` — ``Scheduler._launch_wave_kernel`` (:1814): the
  launch inside the encoder's donation lease.
* ``commit_batch`` — the encoder side of ``Scheduler._commit_batch``
  (:2434): ``add_pod(..., device_synced=True)`` for each placed pod (the
  kernel already committed its occupancy on the device); deferred and
  unplaced pods go back to the next batch.
* ``schedule_batch`` — one turn of ``_schedule_batch_wave_once`` (:2094):
  ``prepare_batch`` (template encode → pair table → flush), the launch,
  and ``finish_batch`` (readback → guards, ``ops/lattice.py`` :696 and
  :716 → commit).
* ``schedule_pods`` — batch after batch until every pod is placed or a
  batch places nothing.

``WavePathConfig`` defaults are the reference's accelerator settings
(``scheduler.py:424-452``): batch 4096, ``m_cand`` 512 and ``wave_n_waves``
16 (``config.py:146``); ``score_refresh`` and the fit-mask kernel are
always on, with the reference's default hard-affinity weight and
RequestedToCapacityRatio shape. A batch is encoded at its own size: the
reference pads to two batch buckets (and gives the small one a narrow
candidate list) to bound its XLA compile variants, and eager PyTorch
compiles none. The API server, informers, queue, bind and the split-phase
readback are the next slice; here the readback is one blocking copy per
batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.objects import Pod
from ..ops.encoding import ETERM_ANTI_REQ, SnapshotEncoder
from ..ops.lattice import (
    KernelGuardTrip,
    validate_batch_outputs,
    validate_trailing_score,
)
from ..ops.templates import (
    EncodedTemplateBatch,
    PairTable,
    TemplateCache,
    build_pair_table,
)
from ..ops.wavelattice import WaveKernel, WaveResult, make_wave_kernel


@dataclass(frozen=True)
class WavePathConfig:
    batch_size: int = 4096  # device_batch_size (accelerator auto)
    m_cand: int = 512  # wave_m_cand (accelerator auto)
    n_waves: int = 16  # wave_n_waves (batches with hard pairs)


@dataclass
class BatchOutcome:
    placed: List[Tuple[Pod, str]]  # (pod, node name), committed to the encoder
    retry: List[Pod]  # deferred or unplaced: back to the next batch
    fallback: List[Pod]  # overflowed the device buckets (host path: later slice)
    n_waves: int
    has_hard: bool
    encode_s: float  # template encode + pair table + flush
    kernel_s: float  # launch + readback of the index payload and score
    commit_s: float  # guards + host replay


@dataclass
class ScheduleResult:
    placed: List[Tuple[Pod, str]] = field(default_factory=list)
    unscheduled: List[Pod] = field(default_factory=list)
    fallback: List[Pod] = field(default_factory=list)
    batches: List[BatchOutcome] = field(default_factory=list)


def batch_waves(
    enc: SnapshotEncoder, eb: EncodedTemplateBatch, n_waves: int
) -> Tuple[int, bool]:
    """(wave count, has_hard) for THIS batch, from the templates actually
    present in it. Batches without hard pairs (hard spread, incoming
    anti-affinity, or existing pods' required anti-affinity matching a
    template) drain in 1-2 waves; hard-pair batches keep the configured
    count."""
    b = eb.tpl_np
    present = np.unique(eb.pod_tpl_np[eb.pod_tpl_np >= 0])
    if present.size == 0:
        return min(2, n_waves), False
    anti_kinds = [
        tid
        for tid in range(len(enc.eterm_vocab))
        if enc.eterm_vocab.items[tid].kind == ETERM_ANTI_REQ
    ]
    has_hard = (
        bool(np.any((b.spread_key[present] >= 0) & b.spread_hard[present]))
        or bool(np.any(b.panti_sid[present] >= 0))
        or any(bool(np.any(b.match_eterm[present, tid])) for tid in anti_kinds)
    )
    if has_hard:
        return n_waves, True
    return min(2, n_waves), False


def launch_wave_kernel(
    enc: SnapshotEncoder,
    kern: WaveKernel,
    batch,
    ptab,
    weights: torch.Tensor,
    rng: torch.Generator,
) -> WaveResult:
    """Run the wave kernel inside the encoder's donation lease: the lease
    hands the kernel the sealed live snapshot (or a clone when a reader
    pins it), the kernel updates it in place, and the lease installs it
    as the next generation."""
    with enc.donation_lease() as dl:
        new_snap, res = kern(dl.snap, batch, ptab, weights, rng)
        dl.result = new_snap
    return res


def commit_batch(
    enc: SnapshotEncoder,
    eb: EncodedTemplateBatch,
    row_names: Sequence[Optional[str]],
    chosen: np.ndarray,
    placed: np.ndarray,
) -> Tuple[List[Tuple[Pod, str]], List[Pod], List[Pod]]:
    """Replay the kernel's placements into the host masters without
    marking rows dirty (the device snapshot already holds them). Returns
    (placed, retry, fallback)."""
    done: List[Tuple[Pod, str]] = []
    retry: List[Pod] = []
    fallback: List[Pod] = []
    protos: dict = {}  # template -> shared encoder proto
    for i, pod in enumerate(eb.pods):
        if eb.fallback[i]:
            fallback.append(pod)
            continue
        if not placed[i]:
            retry.append(pod)
            continue
        node_name = row_names[int(chosen[i])]
        if node_name is None:
            # the row's node left between flush and commit
            retry.append(pod)
            continue
        t = int(eb.pod_tpl_np[i])
        proto = protos.get(t)
        if proto is None:
            proto = protos[t] = enc.pod_proto(pod)
        enc.add_pod(
            node_name, pod, device_synced=True,
            prio_band=int(eb.pod_band_np[i]), proto=proto,
        )
        done.append((pod, node_name))
    return done, retry, fallback


@dataclass
class PreparedBatch:
    eb: EncodedTemplateBatch
    ptab: PairTable
    kern: WaveKernel
    row_names: List[Optional[str]]
    n_waves: int
    has_hard: bool
    encode_s: float


def prepare_batch(
    enc: SnapshotEncoder,
    cache: TemplateCache,
    pods: Sequence[Pod],
    cfg: WavePathConfig = WavePathConfig(),
) -> PreparedBatch:
    """Template encode → pair table → wave count → flush, and the kernel
    for this batch."""
    t0 = time.perf_counter()
    eb = cache.encode(list(pods))
    ptab, _overflow = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    n_waves, has_hard = batch_waves(enc, eb, cfg.n_waves)
    enc.flush()
    kern = make_wave_kernel(
        enc.cfg.v_cap,
        cfg.m_cand,
        n_waves,
        use_pallas_fit=True,
        score_refresh=True,
        has_pinned=bool((eb.pod_name_row_np >= 0).any()),
    )
    return PreparedBatch(
        eb, ptab, kern, list(enc.row_names), n_waves, has_hard,
        time.perf_counter() - t0,
    )


def finish_batch(
    enc: SnapshotEncoder, prep: PreparedBatch, res: WaveResult, kernel_s: float
) -> BatchOutcome:
    """Read back the index payload and score, run the guards, commit.
    Raises KernelGuardTrip (after invalidating the device snapshot) when
    the read-back fails the guards — before any placement is replayed."""
    t0 = time.perf_counter()
    chosen, placed, score = (
        x.cpu().numpy() for x in (res.chosen, res.placed, res.score)
    )
    t1 = time.perf_counter()
    reason = validate_batch_outputs(chosen, placed, None, len(prep.row_names))
    reason = reason or validate_trailing_score(score, placed)
    if reason:
        enc.invalidate_device()
        raise KernelGuardTrip(reason)
    done, retry, fallback = commit_batch(
        enc, prep.eb, prep.row_names, chosen, placed
    )
    return BatchOutcome(
        done, retry, fallback, prep.n_waves, prep.has_hard, prep.encode_s,
        kernel_s + (t1 - t0), time.perf_counter() - t1,
    )


def schedule_batch(
    enc: SnapshotEncoder,
    cache: TemplateCache,
    pods: Sequence[Pod],
    weights: torch.Tensor,
    rng: torch.Generator,
    cfg: WavePathConfig = WavePathConfig(),
) -> BatchOutcome:
    """One wave batch end to end: prepare → launch → finish."""
    prep = prepare_batch(enc, cache, pods, cfg)
    t0 = time.perf_counter()
    res = launch_wave_kernel(enc, prep.kern, prep.eb.batch, prep.ptab, weights, rng)
    return finish_batch(enc, prep, res, time.perf_counter() - t0)


def schedule_pods(
    enc: SnapshotEncoder,
    cache: TemplateCache,
    pods: Sequence[Pod],
    weights: torch.Tensor,
    rng: torch.Generator,
    cfg: WavePathConfig = WavePathConfig(),
) -> ScheduleResult:
    """Schedule `pods` batch by batch; retried pods lead the next batch.
    Stops when every pod is placed or a batch places nothing (the rest
    are returned unscheduled)."""
    out = ScheduleResult()
    queue = list(pods)
    while queue:
        batch, queue = queue[: cfg.batch_size], queue[cfg.batch_size:]
        bo = schedule_batch(enc, cache, batch, weights, rng, cfg)
        out.batches.append(bo)
        out.placed.extend(bo.placed)
        out.fallback.extend(bo.fallback)
        if not bo.placed:
            out.unscheduled = bo.retry + queue
            break
        queue = bo.retry + queue
    return out
