"""The device-facing half of the scheduler's wave path, as plain functions.

``scheduler/scheduler.py`` (the port's ``Scheduler``) drives the same
pieces from its queue: ``wave_bucket``, ``batch_waves`` and ``HostCopy``
(its split-phase readback). The functions below run them without the API
server, queue or bind — the data-plane loop ``chip_smoke.py`` times.

Counterparts in ``kubernetes_tpu/scheduler/scheduler.py``:

* ``wave_bucket`` — the two padded-batch buckets of
  ``_schedule_batch_wave_once`` (:2105-2118): a batch of at most
  ``min(256, batch)`` pods pads to that small bucket and, when the small
  bucket is narrower than the batch, takes ``m_cand_small`` candidates
  (and at most 2 waves when it has no hard pairs, :2137-2142).
* ``batch_waves`` — ``Scheduler._batch_waves`` (:1721): the wave count and
  whether the batch has hard pairs, from the templates present in it.
* ``HostCopy`` — the split-phase readback (``copy_to_host_async`` at
  :1846-1849, ``_device_ready`` at :119): a device->host copy started on a
  side CUDA stream into pinned host tensors, ready when its event is.
* ``HostCallbackDelivery`` — the delivery side of ``host_callback_binds``
  (the reference's ``io_callback`` into ``ops/hostcallback``, :2201-2223):
  the fast index payload's ``HostCopy`` goes to one waiter thread, which
  delivers it to the ticket registry once the copy's event has fired.
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
(``scheduler.py:424-452``): batch 4096, ``m_cand`` 512, ``wave_m_cand_small``
32 and ``wave_n_waves`` 16 (``config.py``); ``score_refresh`` and the
fit-mask kernel are always on, with the reference's default hard-affinity
weight and RequestedToCapacityRatio shape. Here the readback is one
blocking copy per batch.
"""

from __future__ import annotations

import logging
import queue
import threading
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
from ..ops import hostcallback
from ..ops.wavelattice import WaveKernel, WaveResult, make_wave_kernel

logger = logging.getLogger("kubernetes_tpu_torch.scheduler.wavepath")


@dataclass(frozen=True)
class WavePathConfig:
    batch_size: int = 4096  # device_batch_size (accelerator auto)
    m_cand: int = 512  # wave_m_cand (accelerator auto)
    n_waves: int = 16  # wave_n_waves (batches with hard pairs)
    m_cand_small: int = 32  # wave_m_cand_small (the small bucket)


def wave_bucket(
    n_pods: int, batch_size: int, small: int, m_cand: int, m_cand_small: int
) -> Tuple[int, bool, int]:
    """(pad, small_bucket, m_cand) for a batch of n_pods: ragged tails of
    at most `small` pods pad to the small bucket, bursts to batch_size.
    The small bucket rides the narrow candidate list only when it is
    narrower than the batch (the reference's `small < batch_size`)."""
    pad = small if n_pods <= small else batch_size
    small_bucket = pad == small and small < batch_size
    return pad, small_bucket, (min(m_cand_small, m_cand) if small_bucket else m_cand)


class HostCopy:
    """A device->host copy of a few tensors, started now and consumed
    later. On a CUDA device the copy runs on `stream` (a side stream that
    first waits for everything already queued on the current stream):
    each source goes into a pinned host tensor with ``non_blocking=True``,
    is ``record_stream``-ed on the side stream so the caching allocator
    cannot reuse its memory under the in-flight copy, and an event is
    recorded after the last copy. ``ready()`` is that event's ``query()``;
    ``arrays()`` waits on it (``synchronize()``) and returns numpy views of
    the pinned buffers, which this object keeps alive. On the CPU the copy
    is synchronous and always ready."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors: Sequence[torch.Tensor], stream=None):
        dev = tensors[0].device
        if dev.type != "cuda":
            self._host = [t.detach().clone() for t in tensors]
            self._event = None
            return
        if stream is None:
            raise ValueError("HostCopy of CUDA tensors needs a side stream")
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
                host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        self._host = host

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def arrays(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class HostCallbackDelivery:
    """The delivery side of ``host_callback_binds`` for one Scheduler.

    ``post(ticket, *tensors)`` starts a ``HostCopy`` of the tensors on the
    side stream and returns it (the launch keeps it as its split-phase
    fast copy). On a CUDA device the copy goes to one daemon thread, which
    waits on the copy's event and calls ``hostcallback.deliver(ticket,
    ...)`` with numpy copies of the pinned buffers; the scheduling loop
    never blocks on it. On the CPU the copy is synchronous and the
    delivery happens inside ``post``. A ticket discarded before its
    delivery is dropped by the registry.

    Why not ``cudaLaunchHostFunc``: its host function may make no CUDA
    call, and it would have to take the GIL on a CUDA callback thread
    while the scheduling loop holds it to launch. The waiter thread needs
    neither: ``Event.synchronize`` releases the GIL while it waits."""

    def __init__(self, stream=None):
        self._stream = stream
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def post(self, ticket: int, *tensors: torch.Tensor) -> HostCopy:
        copy = HostCopy(tensors, self._stream)
        if tensors[0].device.type != "cuda":
            self._deliver(ticket, copy)
            return copy
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="hostcb-delivery"
                )
                self._thread.start()
        self._queue.put((ticket, copy))
        return copy

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            self._deliver(*item)

    def _deliver(self, ticket: int, copy: HostCopy) -> None:
        try:
            arrays = copy.arrays()
        except Exception:
            # the consumer's take() times out and reads the same copy
            # itself, where the error surfaces on the scheduling loop
            logger.exception("host-callback delivery of ticket %d failed", ticket)
            return
        hostcallback.deliver(ticket, *(np.array(a) for a in arrays))

    def close(self, timeout: float = 5.0) -> None:
        """Stop the waiter thread once the copies posted so far are
        delivered."""
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._queue.put(None)
            thread.join(timeout)


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
    """Bucket → template encode (padded to the bucket) → pair table → wave
    count → flush, and the kernel for this batch."""
    t0 = time.perf_counter()
    pad, small_bucket, m_cand = wave_bucket(
        len(pods), cfg.batch_size, min(256, cfg.batch_size), cfg.m_cand,
        cfg.m_cand_small,
    )
    eb = cache.encode(list(pods), pad_to=pad)
    ptab, _overflow = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    n_waves, has_hard = batch_waves(enc, eb, cfg.n_waves)
    if small_bucket and not has_hard:
        n_waves = min(n_waves, 2)
    enc.flush()
    kern = make_wave_kernel(
        enc.cfg.v_cap,
        m_cand,
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
