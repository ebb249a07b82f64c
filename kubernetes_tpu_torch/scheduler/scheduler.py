"""The Scheduler: event pipeline → batched device cycles → assume → bind.

PyTorch port of ``kubernetes_tpu/scheduler/scheduler.py`` on its wave
path. The loop, the queue, the cache, assume/bind, the host fallback and
preemption, the guards, the ride-through and the leadership fence are the
reference's, method for method; what changed is the device half:

* The wave kernel is ``ops/wavelattice.WaveKernel`` on torch tensors on
  the scheduler's explicit ``device`` (``None`` means the CUDA card and
  raises without one; the tests pass ``device="cpu"``). Its tie noise is
  an input: a ``noise(P, m_c)`` source given at construction, by default
  ``torch.rand`` from a ``torch.Generator`` on the device seeded from
  ``seed`` (the reference splits ``jax.random.PRNGKey(0)`` per batch).
* The split-phase readback: at dispatch, inside the donation lease, a side
  CUDA stream waits on the launch stream and copies ``chosen``, ``placed``
  and ``deferred`` into pinned host tensors (``non_blocking=True``), then
  records an event; ``score`` follows as a second copy with its own event
  (``wavepath.HostCopy``). "Ready" is ``Event.query()`` and a blocking
  fetch is ``Event.synchronize()``, counted in
  ``scheduler_wave_readbacks_blocking_total`` only when the query was
  still False. Each source tensor is ``record_stream``-ed on the side
  stream and each pinned buffer lives until its entry is consumed. On the
  CPU the copies are synchronous and every entry is ready.
* Two threads issue device work: the scheduling loop, and the snapshot
  auditor (``scheduler/antientropy.py``, on its own thread every
  ``antientropy_period_s``). The auditor writes (a settling or repair
  flush, a rebuild) only under the cache lock and only while the wave
  pipeline is quiescent (nothing pending, not busy, the device not
  down), so its writes never interleave with a batch's; its reads are
  ``SnapshotEncoder.fetch_device_rows`` under a generation pin on the
  device's default stream, the stream every writer queues on. The
  ``host_callback_binds`` delivery thread only waits on copy events. The
  bind pool and the informer threads stay on the host.
* Accelerator settings (batch 4096, ``m_cand`` 512, the per-wave score
  refresh and the K1 fit kernel) follow ``device.type == "cuda"`` where the
  reference tests ``jax.default_backend() == "tpu"``.
* ``use_wave=False`` runs the serial lattice (``ops/lattice.make_schedule_batch``,
  a loop over pods on the device) through ``_schedule_batch_device``. Its
  tie noise is an input too: a ``serial_noise(P, N)`` source, by default
  ``torch.rand`` from the same device Generator (the reference splits the
  batch key per pod). Split-phase, the ``chosen`` vector comes back through
  a ``wavepath.HostCopy`` and the score trails behind it
  (``_register_trailing(..., path="serial")``).
* ``vector_preemption=True`` (the default) ranks a resolved wave's failed
  pods' victims in one ``ops/preemptlattice.preempt_select`` pass over a
  (template, priority)-grouped batch before the host Preemptor checks
  the ranked nodes exactly.
* The warm standby (``start_standby``) keeps the device snapshot in step
  with the informers and launches the small-bucket wave kernel and the
  serial kernel once with an unsatisfiable ghost pod before ``promote``.

* The data-plane defense is the reference's: a batch that trips the
  kernel-output guards is quarantined to the host path (newer in-flight
  batches are pulled with ``sibling_quarantine``) and the snapshot is
  rebuilt; a launch or readback that fails with a device-loss error
  (``parallel/sharded.is_device_loss_error``, which knows the CUDA
  runtime's device-gone errors and leaves program faults such as an
  illegal address alone) gets ``device_retry_attempts`` jittered retries,
  then the ladder of ``_handle_device_loss``; ``device_loss_disable_after``
  consecutive trips or losses latch the device off
  (``scheduler_device_down``) and every batch takes the host path. The
  single-device branch of the ladder probes the card once
  (``parallel/mesh._default_probe``); on a mesh the ladder probes every
  entry and shrinks the mesh to the largest power-of-two prefix of the
  survivors (re-sharding the snapshot), or pins to one survivor.
* The mesh (the reference's ``use_mesh``): with ``mesh_devices`` of more
  than one entry (None: every visible CUDA device when ``device`` is
  CUDA) and ``cfg.use_mesh``, ``_bringup`` adopts ``parallel/mesh.Mesh``
  and the encoder shards the snapshot's rows over it
  (``SnapshotEncoder.set_sharding``); every wave and serial launch then
  goes through ``parallel/sharded``'s node-sharded kernels, host
  callbacks stay off, as in the reference. The victim selection, the
  preemption what-if, the auditor's fetch and the what-if overlay read a
  sharded snapshot through ``ops/encoding.gather_snapshot``, which
  assembles the rows they need on the mesh's first device.
  ``parallel/mesh.virtual_devices("cpu", 8)`` runs a mesh on the CPU.
  A mesh that would span processes (entries of several processes, or any
  mesh under a process group of more than one) is refused at
  construction, as the reference's Scheduler never runs one: it reads the
  snapshot on the host and its device-loss ladder probes devices in its
  own process.
* ``host_callback_binds=True`` launches ``ops/wavelattice.make_wave_kernel_cb``
  under a ``ops/hostcallback`` ticket: the fast index payload's split-phase
  copy goes to ``wavepath.HostCallbackDelivery``, whose thread delivers it
  to the registry when the copy's event fires, and the resolve takes the
  delivery instead of reading the copy itself.

* The policy gym's wave recorder (``wave_recorder``, set by
  ``tuner/controller.PolicyTuner``) records each committed serial and wave
  batch. Where the reference records the launch's PRNG key, a record here
  keeps ``_noise_key``: the device Generator's state taken just before the
  draw (``get_state()``, a small host tensor, never the ``[P, N]`` noise),
  or an injected source's ``replay_key()``, so the gym's replay of a
  serial wave redraws production's noise exactly.

Every setting of the reference's configuration runs (``_unported_settings``
is empty). The preemption what-if mask is ``ops/lattice.preempt_whatif``
on torch.

The reference's design notes follow.

Top-loop equivalent of reference pkg/scheduler/scheduler.go:79 (Scheduler),
:363 (Run), :548 (scheduleOne), re-shaped around the TPU data plane:

  reference                           this build
  ---------                           ----------
  queue.Pop one pod                   queue.pop_batch(P) — batch former
  UpdateSnapshot (generation diff)    encoder.flush() — device row scatter
  findNodesThatFitPod / prioritize    one fused lattice kernel for the batch
  (16 goroutines over nodes)          (vmap/scan over pods×nodes on device)
  selectHost                          on-device argmax + random tie-break
  assume + async bind goroutine       assume + bind worker pool (unchanged)
  preempt on FitError                 host preemption seeded by the kernel's
                                      resolvable mask (see preemption.py)

Pods whose spec overflows the static device encoding run the host fallback
path (core.GenericScheduler) — same plugins, same outcome, lower throughput;
mirrors how the reference lets extenders post-process a narrowed node set
(generic_scheduler.go:421).
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..api import objects as v1
from ..client.apiserver import APIServer, LeaderFenced, NotFound, NotPrimary
from ..client.informers import SharedInformerFactory
from ..device import DeviceLike, resolve_device
from ..runtime.consensus import DegradedWrites
from ..controller.volume_scheduling import VolumeBinder
from ..api.objects import Binding
from ..ops.batch import encode_pod_batch
from ..ops.encoding import PodBatch, SnapshotEncoder, gather_snapshot, num_rows
from ..ops.preemptlattice import preempt_select, validate_preempt_outputs
from ..ops.templates import TemplateCache, build_pair_table
from ..ops import hostcallback
from ..ops.wavelattice import (
    DEFAULT_RTC_SHAPE,
    make_wave_kernel,
    make_wave_kernel_cb,
)
from ..parallel.sharded import (
    call_with_device_retry,
    device_retry_delay,
    is_device_loss_error,
)
from ..ops.lattice import (
    GUARD_TRAILING_LOSS,
    KernelGuardTrip,
    NUM_SCORE_COMPONENTS,
    SC_BALANCED,
    SC_IMAGE,
    SC_INTERPOD,
    SC_LEAST_ALLOC,
    SC_MOST_ALLOC,
    SC_NODE_AFFINITY,
    SC_PREFER_AVOID,
    SC_REQ_TO_CAP,
    SC_SELECTOR_SPREAD,
    SC_TAINT,
    SC_TOPO_SPREAD,
    make_schedule_batch,
    preempt_whatif,
    validate_batch_outputs,
    validate_trailing_score,
    weights_for_policy,
)
from ..utils.metrics import metrics
from ..utils.trace import Trace
from ..utils.tracing import tracer
from .antientropy import SnapshotAntiEntropy
from .cache.cache import SchedulerCache
from .config import KubeSchedulerConfiguration
from .core import FitError, GenericScheduler
from .extender import build_extenders
from .framework.interface import Code, CycleState, is_success
from .preemption import Preemptor
from .profile import ProfileMap, new_profile_map
from .queue import PriorityQueue, QueuedPodInfo
from .ridethrough import COUNTER_RECONCILED, BindRideThrough, PendingBind
from .ha import (
    COUNTER_ADOPTIONS,
    COUNTER_FENCED_BINDS,
    COUNTER_PROMOTIONS,
    COUNTER_STANDBY_FLUSHES,
    COUNTER_STANDBY_WARMUPS,
    GAUGE_ROLE,
    GAUGE_STANDBY_SNAPSHOT_AGE,
)
from .wavepath import HostCallbackDelivery, HostCopy, batch_waves, wave_bucket
from . import eventhandlers

logger = logging.getLogger("kubernetes_tpu_torch.scheduler")

# wave pipeline observability: batches launched-but-unresolved right now,
# the high-water mark since start (the "≥2 waves in flight" acceptance
# gauge), and the configured/auto-probed pipeline depth
GAUGE_WAVE_INFLIGHT = "scheduler_wave_inflight"
GAUGE_WAVE_INFLIGHT_MAX = "scheduler_wave_inflight_max"
GAUGE_WAVE_PIPELINE_DEPTH = "scheduler_wave_pipeline_depth"
# split-phase readback counters: fast = index-payload fetches
# (the bind-critical resolve), blocking = fetches that actually had to
# wait on the device (the readbacks_per_bind numerator), trailing = bulk
# score fetches consumed off the critical path
COUNTER_WAVE_FAST_READBACKS = "scheduler_wave_fast_readbacks_total"
COUNTER_WAVE_BLOCKING_READBACKS = "scheduler_wave_readbacks_blocking_total"
COUNTER_WAVE_TRAILING_READBACKS = "scheduler_wave_trailing_readbacks_total"
COUNTER_WAVE_TRAILING_UNWOUND = "scheduler_wave_trailing_unwound_assumes_total"
GAUGE_WAVE_TRAILING_BACKLOG = "scheduler_wave_trailing_backlog"
# host_callback_binds: fast payloads consumed from a host-callback delivery
# (zero device syncs on the bind-critical path)
COUNTER_WAVE_HOSTCB = "scheduler_wave_hostcb_deliveries_total"
# snapshot auditor passes that skipped, by the report's reason ("pipeline
# busy", "no device snapshot", "no live rows"); the copied auditor counts
# only its completed passes
COUNTER_AUDIT_SKIPS = "snapshot_audit_skips_total"


@contextmanager
def _stage_timer(stage: str):
    """Feed the bench's stage_breakdown_s (encode vs kernel time per batch).

    Records wall AND this-thread CPU time: on a saturated box a stage's
    wall inflates with GIL/scheduler starvation from unrelated threads,
    which is unattributable from wall alone (a soak once recorded a 30 s
    'finish' wall whose actual work was ~0.7 s). The CPU series is the
    work; the wall minus CPU is time spent descheduled or blocked."""
    t0 = time.monotonic()
    c0 = time.thread_time()
    try:
        yield
    finally:
        metrics.observe(
            "scheduling_stage_duration_seconds",
            time.monotonic() - t0,
            {"stage": stage},
        )
        metrics.observe(
            "scheduling_stage_cpu_seconds",
            time.thread_time() - c0,
            {"stage": stage},
        )

class _InFlightBatch:
    """A wave batch whose kernel is dispatched but whose results haven't
    been read back yet (pipeline depth 1)."""

    __slots__ = (
        "pis", "eb", "row_names", "res", "moves0", "trace", "t_start",
        "snapshot", "launch_gen", "wave_tid", "t_launched", "copies",
        "ticket", "trailing", "weights", "rng_key",
    )

    def __init__(
        self, pis, eb, row_names, res, moves0, trace, t_start, snapshot=None,
        launch_gen=0, wave_tid="", t_launched=0.0, copies=None, ticket=None,
        weights=None, rng_key=None,
    ):
        self.pis = pis
        self.eb = eb
        self.row_names = row_names
        self.res = res
        self.moves0 = moves0
        self.trace = trace
        self.t_start = t_start
        # per-wave trace (utils/tracing.py): the fan-in id the N pod
        # traces of this batch reference, plus the launch-complete stamp
        # the resolve path closes the shared `device` span against
        self.wave_tid = wave_tid
        self.t_launched = t_launched
        # host snapshot captured AT LAUNCH (verify_cycles only): the state
        # the device encoding was built from — verifying against resolve-
        # time state would report informer churn as device/host mismatches
        self.snapshot = snapshot
        # cache EXTERNAL generation at launch: the oracle guard skips nodes
        # whose ext_generation moved past this (informer churn after the
        # encoding was captured is not a kernel-correctness signal).
        # Scheduler assumes don't move ext_generation, so sibling-batch
        # commits — state the device chain already saw — keep their nodes
        # eligible for the check
        self.launch_gen = launch_gen
        # split-phase readback: (fast index HostCopy, trailing score
        # HostCopy) started at dispatch; None in combined mode
        self.copies = copies
        # host_callback_binds: the delivery-registry ticket the launch's
        # fast payload is delivered under (None on the plain path)
        self.ticket = ticket
        # split-phase readback: the _TrailingReadback registered at fast
        # commit (None when nothing was placed, or in combined mode) —
        # whoever consumes it finishes the wave trace
        self.trailing = None
        # the launch's weight vector and tie-noise key, for the policy
        # gym's wave record (Scheduler._record_wave_for_tuner)
        self.weights = weights
        self.rng_key = rng_key


class _CountedAntiEntropy(SnapshotAntiEntropy):
    """The snapshot auditor, also counting its skipped passes by reason
    (``snapshot_audit_skips_total{reason}``), so a run can tell an
    auditor that found nothing from one that never looked."""

    def audit_once(self):
        report = super().audit_once()
        if report["skipped"]:
            metrics.inc(COUNTER_AUDIT_SKIPS, {"reason": report["skipped"]})
        return report


class _TicketedWaveKernel:
    """The host-callback wave kernel bound to one launch's ticket (the
    reference closes over the cb kernel and the ticket the same way):
    called like the plain kernel, it hands ``post`` the fast payload and
    keeps the HostCopy ``post`` started, which the launch takes as its
    split-phase fast copy."""

    __slots__ = ("kern", "ticket", "post", "fast")

    def __init__(self, kern, ticket: int, post):
        self.kern = kern
        self.ticket = ticket
        self.post = post
        self.fast = None

    def with_noise(self, snap, tb, pt, weights, noise):
        return self.kern.with_noise(
            snap, tb, pt, weights, noise, self.ticket, self._post
        )

    def _post(self, ticket, *tensors):
        self.fast = self.post(ticket, *tensors)


class _TrailingReadback:
    """The bulk half of one batch's split-phase resolve: the score
    vector whose fetch + validation trail the bind-critical commit. The
    entry holds a generation pin from fast-commit until its readback
    lands (the graftlint lease discipline: a late disagreement must
    still be able to name suspect rows in the generation the fast
    payload committed into), and remembers enough of the fast decision
    (placed mask + to_bind tuples) to unwind it."""

    __slots__ = (
        "score", "placed", "to_bind", "launch_gen", "wave_tid", "pin",
        "binds_issued", "quarantined", "gated", "t_registered", "path",
    )

    def __init__(
        self, score, placed, to_bind, launch_gen, wave_tid, pin,
        path="wave",
    ):
        self.score = score
        self.placed = placed
        self.to_bind = to_bind
        self.launch_gen = launch_gen
        self.wave_tid = wave_tid
        self.pin = pin
        # False until this entry's batch dispatched its binds: an unwind
        # before then reverts assumes (nothing left the process); after,
        # the bound pods stay and only the snapshot quarantines
        self.binds_issued = False
        self.quarantined = False
        # True only while this entry's own pre-bind gate is draining:
        # tells _unwind_trailing the gate owns the assume revert (it has
        # the per-pod assume errors), preventing a double requeue
        self.gated = False
        self.t_registered = time.monotonic()
        self.path = path

    def ready(self) -> bool:
        return self.score.ready()


_SCORE_NAME_TO_COMPONENT = {
    "NodeResourcesLeastAllocated": SC_LEAST_ALLOC,
    "NodeResourcesMostAllocated": SC_MOST_ALLOC,
    "NodeResourcesBalancedAllocation": SC_BALANCED,
    "RequestedToCapacityRatio": SC_REQ_TO_CAP,
    "NodeAffinity": SC_NODE_AFFINITY,
    "TaintToleration": SC_TAINT,
    "ImageLocality": SC_IMAGE,
    "NodePreferAvoidPods": SC_PREFER_AVOID,
    "PodTopologySpread": SC_TOPO_SPREAD,
    "InterPodAffinity": SC_INTERPOD,
    "DefaultPodTopologySpread": SC_SELECTOR_SPREAD,
}


class _FencedBindSurface:
    """The API surface handed to bind plugins (the framework context's
    ``server``): ``bind_pod``/``bind_pods`` funnel through the scheduler's
    fence-attaching seam (``_bind_pods_fenced``) so the per-pod plugin
    path carries the SAME leadership fence as batch binds — the store (or
    the REST /binding route) rejects a deposed replica's bind with
    LeaderFenced before anything applies. Every other attribute proxies to
    the real server, so out-of-tree plugins built against the APIServer
    surface keep working unchanged."""

    def __init__(self, sched: "Scheduler"):
        self._sched = sched

    def bind_pod(self, binding) -> None:
        errs = self._sched._bind_pods_fenced([binding])
        err = errs[0] if errs else None
        if err is None:
            return
        if isinstance(err, Exception):
            raise err
        raise RuntimeError(str(err))

    def bind_pods(self, bindings, fence=None) -> list:
        # a caller-supplied fence is ignored on purpose: the scheduler's
        # armed fence is the one source of truth for its own binds
        return self._sched._bind_pods_fenced(bindings)

    def __getattr__(self, name: str):
        return getattr(self._sched.server, name)


def _unported_settings(cfg: KubeSchedulerConfiguration, device: torch.device):
    """(setting, ROADMAP queue 1 item) pairs this port does not run yet:
    none since the mesh (item 6) was ported."""
    return []


def _refuse_process_mesh(mesh_devices) -> None:
    """A mesh over processes is not the Scheduler's: raise, naming why."""
    from ..parallel import distributed

    if not mesh_devices:
        return
    procs = {getattr(d, "process", 0) for d in mesh_devices}
    if len(procs) > 1 or distributed.process_count() > 1:
        raise ValueError(
            "the Scheduler does not run a mesh that spans processes "
            f"(entries of processes {sorted(procs)}, "
            f"{distributed.process_count()} in the process group): it reads "
            "the snapshot on the host and its device-loss ladder probes the "
            "devices of its own process, as the reference's Scheduler does; "
            "drive parallel/sharded's kernels directly on such a mesh"
        )


class Scheduler:
    """device: where the snapshot and the kernels live; None means the
    CUDA card (raises without one), "cpu" runs on the CPU. noise: the wave
    kernel's tie-noise source, called as ``noise(P, m_c)`` for a
    ``[P, m_c]`` float32 tensor in [0, 0.999) on the device; serial_noise:
    the serial kernel's, called as ``serial_noise(P, N)`` for a ``[P, N]``
    float32 tensor in [0, 1) (None: both drawn from a ``torch.Generator``
    on the device seeded with ``seed``). mesh_devices: the devices
    ``cfg.use_mesh`` shards the snapshot over (``parallel/mesh`` entries
    or torch devices, the first being `device`); None means every
    visible CUDA device when `device` is CUDA, and no mesh otherwise. A
    mesh is adopted only with more than one entry."""

    def __init__(
        self,
        server: APIServer,
        config: Optional[KubeSchedulerConfiguration] = None,
        device: DeviceLike = None,
        noise: Optional[Callable[[int, int], torch.Tensor]] = None,
        seed: int = 0,
        serial_noise: Optional[Callable[[int, int], torch.Tensor]] = None,
        mesh_devices=None,
    ):
        self.cfg = config or KubeSchedulerConfiguration()
        self.cfg.validate()
        self.device = resolve_device(device)
        if (
            mesh_devices is None
            and self.device.type == "cuda"
            and torch.cuda.device_count() > 1
        ):
            mesh_devices = [
                torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ]
        self._mesh_devices = list(mesh_devices) if mesh_devices is not None else None
        _refuse_process_mesh(self._mesh_devices)
        self._mesh = None  # set by _bringup() when the mesh is adopted
        unported = _unported_settings(self.cfg, self.device)
        if unported:
            raise NotImplementedError(
                "kubernetes_tpu_torch does not run "
                + "; ".join(
                    f"{what} yet (ROADMAP queue 1 item {item})"
                    for what, item in unported
                )
            )
        self.server = server
        self.cache = SchedulerCache(
            ttl_seconds=self.cfg.assume_ttl_seconds,
            encoder=SnapshotEncoder(self.cfg.encoding, device=self.device),
        )
        self._snapshot = None  # latest host snapshot (fallback/preemption)
        self.volume_binder = VolumeBinder(server)
        # which transport enforces the leadership bind fence for this
        # scheduler (labels scheduler_ha_fenced_binds_total): the port has
        # the in-process store only (no REST client yet), whose bind lock
        # validates the fence — "local"
        self._bind_transport = "local"
        context = {
            # bind plugins get the fence-attaching surface, not the raw
            # server: every per-pod DefaultBinder bind funnels through
            # _bind_pods_fenced exactly like batch binds (reads and
            # non-bind writes pass through untouched)
            "server": _FencedBindSurface(self),
            "snapshot_getter": lambda: self._snapshot,
            "hard_pod_affinity_weight": self.cfg.hard_pod_affinity_weight,
            "volume_binder": self.volume_binder,
            "csinode_getter": self._csinode,
            "services_lister": lambda: server.list("services")[0],
            "selectors_for_pod": self._selectors_for_pod,
            "coscheduling_permit_timeout": self.cfg.coscheduling_permit_timeout,
            # extender managedResources flagged ignoredByScheduler: the
            # extender owns their accounting (fit.go IgnoredResources)
            "ignored_extended_resources": frozenset(
                m.name
                for e in self.cfg.extenders
                for m in e.managed_resources
                if m.ignored_by_scheduler
            ),
            "rtc_shape": self.cfg.rtc_shape,
        }
        # static per profile: part of the kernel-variant key so a custom
        # shape compiles its own variant and matches the host plugin
        self._rtc_shape = tuple(
            sorted(tuple(p) for p in (self.cfg.rtc_shape or ()))
        ) or None
        self.profiles: ProfileMap = new_profile_map(self.cfg, context, server=server)
        # queue order comes from the default profile's QueueSort plugin
        # (Configurator wires profiles[0].QueueSortFunc into the queue,
        # factory.go:127; coscheduling overrides it to keep gangs adjacent)
        default_fw = next(iter(self.profiles.values())).framework
        self.queue = PriorityQueue(
            less=default_fw.queue_sort_less,
            pod_initial_backoff=self.cfg.pod_initial_backoff_seconds,
            pod_max_backoff=self.cfg.pod_max_backoff_seconds,
        )
        self.informer_factory = SharedInformerFactory(server)
        self.extenders = build_extenders(self.cfg.extenders)
        self._algo: Dict[str, GenericScheduler] = {
            name: GenericScheduler(
                p.framework,
                self.cfg.percentage_of_nodes_to_score,
                extenders=self.extenders,
            )
            for name, p in self.profiles.items()
        }
        def list_pdbs():
            try:
                pdbs, _ = self.server.list("poddisruptionbudgets")
                return pdbs
            except Exception:
                return []

        self._preemptors = {
            name: Preemptor(
                p.framework, pdb_lister=list_pdbs, extenders=self.extenders
            )
            for name, p in self.profiles.items()
        }
        # one home for the PDB read both the vectorized engine (budget
        # column refresh) and the divergence key share with the Preemptors
        self._list_pdbs = list_pdbs
        self._bind_pool = ThreadPoolExecutor(
            max_workers=self.cfg.bind_workers, thread_name_prefix="binder"
        )
        self._stop = threading.Event()
        self._sched_thread: Optional[threading.Thread] = None
        # the wave kernel's tie noise: the reference splits a PRNG key per
        # batch; here a device Generator (or the caller's source) draws
        # the [P, m_c] noise tensor the kernel takes as input
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = noise or self._draw_noise
        self._serial_noise = serial_noise or self._draw_serial_noise
        # the split-phase readback's side stream: created once, entered
        # explicitly by the scheduling-loop thread (the current stream is
        # thread-local in torch)
        self._copy_stream = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda"
            else None
        )
        # wave pipeline: launched-but-unresolved batches, oldest first. The
        # donated snapshot chains batches on-device, so up to
        # cfg.pipeline_depth-1 batches stay in flight and resolve with ONE
        # combined device->host readback — the readback round trip is paid
        # once per depth-1 batches, and the newest batch's device time still
        # overlaps the readback + host bind work (the batch analogue of the
        # reference's async binding goroutine overlapping the next
        # scheduleOne, scheduler.go:666).
        self._pending: List[_InFlightBatch] = []
        self._wave_inflight_peak = 0  # high-water mark of len(_pending)
        # split-phase readback: resolve on the fast index
        # payload alone (async-copied at dispatch), validate the trailing
        # bulk score off the critical path. auto = on; False restores the
        # combined readback (the A/B baseline arm).
        self._split_phase = (
            self.cfg.split_phase_readback
            if self.cfg.split_phase_readback is not None
            else True
        )
        # trailing bulk readbacks registered at fast commit, oldest
        # first; drained non-blocking before each launch and in the
        # loop's idle beat (scheduling-loop thread only)
        self._trailing: List[_TrailingReadback] = []
        # resolved by start() when cfg.pipeline_depth == 0 (auto)
        self._pipeline_depth = self.cfg.pipeline_depth or 2
        # auto batch size: the card takes the big batch (template-shaped
        # kernel: near-free on device, divides the fixed sync cost), CPU
        # keeps the small one (its kernel compute scales with the batch)
        accel = self.device.type == "cuda"
        self._batch_size = self.cfg.device_batch_size or (
            4096 if accel else 1024
        )
        # the latency (ragged-tail) kernel bucket: one home for the value
        # the batch-fill policy, the launch bucketing, and the standby
        # warm-up all reason about
        self._small_bucket = min(256, self._batch_size)
        # auto: serial-fidelity refresh on the card; on the CPU the same
        # [P, M] per-wave gathers are a large share of the kernel's wall
        self._score_refresh = (
            self.cfg.wave_score_refresh
            if self.cfg.wave_score_refresh is not None
            else accel
        )
        # auto: the hand-written fit-mask kernel (K1) on the card; the CPU
        # takes the plain broadcast either way (fit_kernels.fit_mask)
        self._use_pallas_fit = (
            self.cfg.use_pallas_fit
            if self.cfg.use_pallas_fit is not None
            else accel
        )
        # auto m_cand: 256 on the CPU, 512 on the card (its auto batch is
        # 4096 and a zone-concentrated single-template burst needs enough
        # distinct targets per batch). Explicit values override.
        self._m_cand = self.cfg.wave_m_cand or (512 if accel else 256)
        self._busy = False  # scheduling loop mid-batch (wait_for_idle)
        # degraded-store ride-through (ridethrough.py): binds refused with
        # a retryable 503 park here while the pods stay assumed; the
        # breaker pauses batch dispatch until the store reopens
        self._ridethrough = BindRideThrough(
            capacity=self.cfg.pending_bind_capacity
        )
        # data-plane self-defense state: the anti-entropy auditor
        # (started in start()), the device-down latch (host-path fallback
        # after unrecoverable device loss), and the consecutive-failure
        # counters that decide when retrying stops being worth it
        self._auditor = None
        self._device_down = False
        self._consecutive_device_loss = 0
        self._consecutive_guard_trips = 0
        # host_callback_binds: the waiter thread that delivers each
        # launch's fast payload to the ticket registry
        self._hostcb = (
            HostCallbackDelivery(self._copy_stream)
            if self.cfg.host_callback_binds
            else None
        )
        self._weights = self._build_weights()
        self._score_policy_name = (
            self.cfg.score_policy
            if isinstance(self.cfg.score_policy, str) and self.cfg.score_policy
            else "default"
        )
        # policy-gym attachment point (tuner/waves.WaveRingBuffer when a
        # PolicyTuner is running): device paths record committed waves
        # here; None = recording off, zero hot-path cost
        self.wave_recorder = None
        self._tpl_cache = TemplateCache(self.cache.encoder)
        self._pair_cache: Optional[tuple] = None  # (sig, table)
        # scheduler HA (ha.py): the leadership fencing token armed by
        # promote() — every batch bind carries it so a zombie ex-leader's
        # late binds are rejected at the store — plus the warm-standby
        # refresh loop state (keeps the device snapshot tracking informer
        # churn while no scheduling loop runs)
        self._bind_fence = None
        # process-wide shared eviction budget (controller/evictionbudget.
        # EvictionBudget), injected by the process wiring when this
        # scheduler coexists with other evictors: preemption victim
        # deletes then spend the SAME bucket as nodelifecycle drains and
        # descheduler waves. None (default) = unthrottled preemption, the
        # pre-budget behavior every bench and single-evictor rig keeps.
        self.eviction_budget = None
        self._ha_identity = "scheduler-0"
        self._standby_stop = threading.Event()
        self._standby_thread: Optional[threading.Thread] = None
        self._standby_last_fresh: Optional[float] = None
        # a Cacher created FOR this scheduler (cmd/scheduler.run): stop()
        # tears it down with us, or every run/stop cycle would leak one
        # store watch per kind plus the bookmark thread
        self._owned_read_cache = None
        eventhandlers.add_all_event_handlers(self)

    def _draw_noise(self, p: int, m_c: int) -> torch.Tensor:
        """The default tie-noise source: [p, m_c] uniform in [0, 0.999)
        from the scheduler's device Generator (the reference's
        ``jax.random.uniform(key, (P, m_c), maxval=0.999)``)."""
        return torch.rand(
            (p, m_c), generator=self._rng, device=self.device,
            dtype=torch.float32,
        ) * 0.999

    def _draw_serial_noise(self, p: int, n: int) -> torch.Tensor:
        """The serial kernel's default tie noise: [p, n] uniform in [0, 1)
        from the same Generator (the reference's per-pod
        ``jax.random.uniform(key_i, (N,))``)."""
        return torch.rand(
            (p, n), generator=self._rng, device=self.device,
            dtype=torch.float32,
        )

    def _noise_key(self, source) -> Any:
        """What the policy gym's wave record keeps so a replay redraws the
        tie noise `source` is about to draw (tuner/scoring.tie_noise):
        while the recorder is on, the default sources' Generator state
        taken just before the draw (``get_state()``: a small uint8 host
        tensor, never the noise itself); an injected source's own
        ``replay_key()`` (a ``(P, N) -> tensor`` callable that redraws its
        next draw) if it offers one, else None. Recording off: None."""
        if self.wave_recorder is None:
            return None
        if source == self._draw_noise or source == self._draw_serial_noise:
            return self._rng.get_state()
        replay_key = getattr(source, "replay_key", None)
        return replay_key() if replay_key is not None else None

    # -- wiring --------------------------------------------------------------

    def _csinode(self, name: str):
        try:
            return self.server.get("csinodes", "", name)
        except NotFound:
            return None

    def _selectors_for_pod(self, pod: v1.Pod):
        """Selectors of Services matching the pod (SelectorSpread's lister —
        getSelectors in default_pod_topology_spread.go:43)."""
        from ..api.selectors import selector_from_match_labels
        from .framework.plugins.helpers import services_matching_pod

        services, _ = self.server.list("services")
        return [
            selector_from_match_labels(sel)
            for sel in services_matching_pod(services, pod)
        ]

    def _build_weights(self) -> np.ndarray:
        # an explicit score policy (name or raw vector) overrides the
        # profile-derived weights wholesale: policies ARE weight vectors
        # (ops/lattice.WEIGHT_PROFILES), a kernel input — never a recompile
        if self.cfg.score_policy:
            return weights_for_policy(self.cfg.score_policy)
        w = np.zeros(NUM_SCORE_COMPONENTS, np.float32)
        default = next(iter(self.profiles.values()))
        for name, weight in default.framework.plugin_set.score:
            idx = _SCORE_NAME_TO_COMPONENT.get(name)
            if idx is not None:
                w[idx] = weight
        return w

    def set_score_policy(self, policy) -> None:
        """Swap the live score policy at runtime: `policy` is a name from
        ops/lattice.WEIGHT_PROFILES or a raw [NUM_SCORE_COMPONENTS]
        vector. The weight vector is a per-launch kernel INPUT, so the
        swap takes effect on the next wave with zero recompilation —
        the seam the ROADMAP-5 policy gym promotes tuned vectors through.
        In-flight waves keep the vector they launched with."""
        self._weights = weights_for_policy(policy)
        previous = self._score_policy_name
        self._score_policy_name = (
            policy if isinstance(policy, str) else "custom"
        )
        metrics.inc("scheduler_score_policy_swaps_total")
        from ..tuner.policy import set_active_policy_gauge

        set_active_policy_gauge(self._score_policy_name, previous)

    def _adopt_persisted_score_policy(self) -> None:
        """Adopt the ScorePolicy API object the policy gym persisted, if
        one exists and validates — the restart/failover half of the
        promotion gate (a tuned vector must survive its promoter). Never
        raises: a degraded store or invalid object is a counted skip
        (tuner_policy_adoptions_total{outcome=...}) and the current
        weights stand."""
        from ..tuner.policy import adopt_persisted_policy

        try:
            name = adopt_persisted_policy(self.server)
        except Exception:
            logger.exception("persisted score-policy adoption failed")
            return
        if name is None:
            return
        changed = name != self._score_policy_name
        # apply even when the name matches: adoption just re-registered
        # the persisted VECTOR under that name, and this process's copy
        # may predate the promotion that wrote it
        self.set_score_policy(name)
        if changed:
            logger.warning(
                "scheduler %s adopted persisted score policy %r",
                self._ha_identity, name,
            )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """informers → WaitForCacheSync → queue/janitor/scheduling loops
        (app.Run, cmd/kube-scheduler/app/server.go:142). Equivalent to
        _bringup() + promote() with no standby phase in between — the
        non-HA path every existing caller keeps."""
        self._bringup()
        self.promote()

    def _bringup(self) -> None:
        """informers → WaitForCacheSync → presized encoder → mesh
        sharding → pipeline depth. After this the device snapshot mirrors
        the synced cluster; nothing schedules yet. (The reference's XLA
        scatter-program warm-up has no counterpart in eager torch.)"""
        self.informer_factory.start()
        self.informer_factory.wait_for_cache_sync()
        # presize device capacities from the synced node count so the
        # snapshot is allocated once instead of re-uploaded on growth
        n_nodes = max(
            self.cache.node_count,
            len(self.informer_factory.informer("nodes").indexer),
        )
        with self.cache.lock:
            self.cache.encoder.presize_for_cluster(max(n_nodes, 1))
        # multi-device: shard the snapshot over the mesh (node axis),
        # production wave kernel included
        self._mesh = None
        if (
            self.cfg.use_device
            and self.cfg.use_mesh
            and self._mesh_devices is not None
            and len(self._mesh_devices) > 1
        ):
            from ..parallel.mesh import make_mesh, replicated, snapshot_shardings

            self._mesh = make_mesh(self._mesh_devices)
            with self.cache.lock:
                self.cache.encoder.set_sharding(
                    snapshot_shardings(self._mesh), replicated(self._mesh)
                )
            self._follow_encoder_device()
            metrics.set_gauge("scheduler_mesh_devices", float(self._mesh.size))
        if self.cfg.pipeline_depth == 0 and self.cfg.use_device:
            self._pipeline_depth = self._auto_pipeline_depth()
        metrics.set_gauge(
            GAUGE_WAVE_PIPELINE_DEPTH, float(self._pipeline_depth)
        )

    def promote(self, fence=None) -> None:
        """Leadership start: arm the bind fence, adopt whatever the
        previous leader left mid-flight, then start the scheduling loops
        (auditor, queue flushers, janitor, the batch loop). Called by
        start() directly in the non-HA path (fence None, no standby) and
        by the election winner after start_standby()."""
        was_standby = self._standby_thread is not None
        self._stop_standby_loop()
        self._bind_fence = fence
        if was_standby or fence is not None:
            # the ride-through's bind-outcome discipline, triggered by a
            # leadership transition instead of a store reopen
            t0 = time.monotonic()
            counts = self._adopt_pending()
            metrics.inc(COUNTER_PROMOTIONS)
            logger.warning(
                "scheduler %s promoted to leader in %.0f ms: adopted "
                "%d landed binds, %d in-flight pods to place (fenced), "
                "%d gone",
                self._ha_identity,
                (time.monotonic() - t0) * 1e3,
                counts["bound"], counts["pending"], counts["gone"],
            )
        metrics.set_gauge(GAUGE_ROLE, 1.0, {"identity": self._ha_identity})
        # adopt the persisted tuned score policy (tuner/policy.py): both
        # cold starts (start() routes through here) and HA promotions
        # pick up the gym's promoted vector instead of reverting to the
        # config default — degraded/absent store is a counted skip
        self._adopt_persisted_score_policy()
        if self.cfg.use_device and self.cfg.antientropy_period_s > 0:
            # quiescence gate — a SEMANTIC gate only, since the
            # generational snapshot made the mechanics safe (the audit's
            # gather pins a generation no launch can donate): an in-flight
            # wave batch legitimately holds device commits the masters
            # haven't replayed yet, and a master-vs-device diff would
            # "repair" the kernel's own work away. _busy is set under the
            # queue lock BEFORE the first pod leaves the queue and cleared
            # only after the batch fully resolves, so a lock-held re-check
            # of these flags is race-free against the launch path (which
            # takes the cache lock after _busy is set).
            self._auditor = _CountedAntiEntropy(
                self.cache.encoder,
                lock=self.cache.lock,
                quiesced=lambda: (
                    not self._pending
                    and not self._busy
                    and not self._device_down
                ),
                period_s=self.cfg.antientropy_period_s,
                sample_rows=self.cfg.antientropy_sample_rows,
                rebuild_after=self.cfg.antientropy_rebuild_after,
            )
            self._auditor.start()
        self.queue.run()
        self.cache.start_janitor()
        self._sched_thread = threading.Thread(
            target=self._scheduling_loop, daemon=True, name="scheduler"
        )
        self._sched_thread.start()

    # -- warm standby (scheduler HA, ha.py) -----------------------------------

    def start_standby(
        self, identity: str = "scheduler-0", refresh_period_s: float = 0.25
    ) -> None:
        """Warm-standby mode: informers tail the (shared) watch cache into
        the scheduler cache and queue, the device snapshot is built and
        kept in lockstep with informer churn by a refresh loop, and the
        wave / serial kernels run once — so promote() starts binding in
        well under one autoscaler period instead of after a full rebuild.
        NO scheduling loop runs: the standby acquires nothing and writes
        nothing."""
        self._ha_identity = identity
        self._bringup()
        if self.cfg.use_device:
            try:
                self.warm_standby_kernels()
            except Exception:
                # a failed pre-warm costs promotion latency, never
                # correctness: the leader path launches lazily as before
                logger.exception("standby kernel pre-warm failed")
        metrics.set_gauge(GAUGE_ROLE, 0.0, {"identity": identity})
        self._standby_last_fresh = time.monotonic()
        metrics.set_gauge(
            GAUGE_STANDBY_SNAPSHOT_AGE, 0.0, {"identity": identity}
        )
        self._standby_stop.clear()
        self._standby_thread = threading.Thread(
            target=self._standby_loop,
            args=(refresh_period_s,),
            daemon=True,
            name=f"standby-{identity}",
        )
        self._standby_thread.start()
        logger.info(
            "scheduler %s standing by: cache synced (%d nodes), snapshot "
            "warm, kernels launched once", identity, self.cache.node_count,
        )

    def _standby_loop(self, period_s: float) -> None:
        """Keep the standby's device snapshot tracking the informer
        stream: scatter pending encoder deltas every tick so the dirty-row
        backlog at promotion is bounded by one period, and publish the
        snapshot's freshness age for the SIGUSR2 dump."""
        while not self._standby_stop.wait(period_s):
            try:
                if self.cfg.use_device and not self._device_down:
                    if self.cache.encoder.has_pending_updates:
                        self.cache.device_snapshot()  # flush under the lock
                        metrics.inc(COUNTER_STANDBY_FLUSHES)
                    self._standby_last_fresh = time.monotonic()
                elif not self.cfg.use_device:
                    # host-only scheduling: the cache IS the state, there
                    # is no device snapshot to go stale
                    self._standby_last_fresh = time.monotonic()
                # _device_down: deliberately do NOT advance — the snapshot
                # really is going stale, and this gauge exists precisely
                # to make a cold standby visible before a promotion
            except Exception:
                logger.exception("standby snapshot refresh failed")
            if self._standby_last_fresh is not None:
                metrics.set_gauge(
                    GAUGE_STANDBY_SNAPSHOT_AGE,
                    max(0.0, time.monotonic() - self._standby_last_fresh),
                    {"identity": self._ha_identity},
                )

    def _stop_standby_loop(self) -> None:
        self._standby_stop.set()
        t, self._standby_thread = self._standby_thread, None
        if t is not None:
            t.join(timeout=5.0)

    def warm_standby_kernels(self) -> None:
        """Launch, once, the kernels the leader path needs first: the
        small-bucket wave kernel variant and the serial batch kernel (the
        reference compiles them here; eager torch pays their first-launch
        costs — the K1 library load, the caching allocator's first blocks).
        Uses one synthetic unsatisfiable pod — a resource request no node
        can hold — so both kernels run at real shapes while committing
        nothing; if the readback ever shows a placement anyway, the device
        snapshot is invalidated and rebuilt from the host masters rather
        than trusted with a ghost pod."""
        warm_pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name="standby-warmup", namespace="kube-system"
            ),
            spec=v1.PodSpec(
                containers=[v1.Container(requests={"cpu": "1000000"})]
            ),
        )
        small = self._small_bucket
        with self.cache.lock:
            eb = self._tpl_cache.encode([warm_pod], pad_to=small)
            ptab = self._pair_table(eb)
            n_waves, batch_has_hard = self._batch_waves(eb)
            n_waves = min(n_waves, 2)  # the small no-hard bucket's count
            snap = self.cache.encoder.flush()
            enc_cfg = self.cache.encoder.cfg
        m_cand = min(self.cfg.wave_m_cand_small, self._m_cand)
        kern = self._wave_kernel((
            enc_cfg.v_cap,
            m_cand,
            n_waves,
            self.cfg.hard_pod_affinity_weight,
            self._use_pallas_fit,
            self._score_refresh or batch_has_hard,
            self._rtc_shape or DEFAULT_RTC_SHAPE,
            False,
        ))
        noise = self._noise(small, min(m_cand, enc_cfg.n_cap))
        _new_snap, res, _copies = self._launch_wave_kernel(
            kern, snap, eb.batch, ptab, np.asarray(self._weights), noise
        )
        placed = res.placed.cpu().numpy()
        with self.cache.lock:
            if placed.any():
                # the "unsatisfiable" pod somehow placed (encoding clamp):
                # never trust the warm launch's snapshot with a ghost pod.
                # (The launch's donation lease already installed it as the
                # live generation — rebuild over it from the host masters.)
                logger.error(
                    "standby warm-up pod was placed by the kernel; "
                    "rebuilding the device snapshot from the host masters"
                )
                self.cache.encoder.invalidate_device()
                self.cache.encoder.flush()
        # the serial batch kernel (the use_wave=False device path)
        kern2 = self._serial_kernel(enc_cfg.v_cap)
        with self.cache.lock:
            eb2 = encode_pod_batch(
                self.cache.encoder, [warm_pod], pad_to=1
            )
            snap2 = self.cache.encoder.flush()
        self._run_serial_kernel(
            kern2, snap2, eb2.batch, self._serial_noise(1, num_rows(snap2)),
        )
        metrics.inc(COUNTER_STANDBY_WARMUPS)

    def _wave_kernel(self, variant: tuple):
        """The wave kernel of `variant` (make_wave_kernel's arguments):
        node-sharded over the mesh when one is adopted."""
        if self._mesh is not None:
            from ..parallel.sharded import make_sharded_wave_kernel

            v_cap, m_cand, n_waves, hard_w, *rest = variant
            return make_sharded_wave_kernel(v_cap, m_cand, n_waves, hard_w, self._mesh, *rest)
        return make_wave_kernel(*variant)

    def _serial_kernel(self, v_cap: int):
        """The serial batch kernel: node-sharded over the mesh when one is
        adopted (the reference partitions the same jit automatically)."""
        if self._mesh is not None:
            from ..parallel.sharded import make_sharded_schedule_batch

            return make_sharded_schedule_batch(
                v_cap, self._mesh, self.cfg.hard_pod_affinity_weight
            )
        return make_schedule_batch(v_cap, self.cfg.hard_pod_affinity_weight)

    def _follow_encoder_device(self) -> None:
        """Re-home the scheduler's device state (tie-noise Generator,
        split-phase copy stream, template cache) on the encoder's device
        when set_sharding moved it (a mesh whose first entry, or a shrink
        survivor, is another card). No-op while it is unchanged, as on a
        mesh of virtual devices of one card."""
        dev = self.cache.encoder.device

        def index(d):
            if d.type == "cuda" and d.index is None:
                return torch.cuda.current_device()
            return d.index

        if dev.type == self.device.type and index(dev) == index(self.device):
            return
        self.device = dev
        seed = int(torch.randint(0, 2**62, (1,), generator=self._rng, device=self._rng.device))
        self._rng = torch.Generator(device=dev).manual_seed(seed)
        if dev.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device=dev)
        with self.cache.lock:
            self._tpl_cache = TemplateCache(self.cache.encoder)
        self._pair_cache = None

    def _adopt_pending(self) -> Dict[str, int]:
        """Leader-adoption pass: the pending-bind reconciler's
        outcome discipline applied at a leadership transition. Every pod
        the informers queued is read back from the STORE (the only
        authority that survives the old leader): bind landed → finish
        (cache it, drop it from the queue — never re-placed), never
        landed → stays queued and the first wave places it with a fenced
        bind (the store's already-bound + uid + leadership checks make a
        double-bind structurally impossible even against a zombie), pod
        gone → forget. Any pending binds buffered by an earlier leading
        stint of THIS process drain through the store-reopen reconciler
        unchanged."""
        counts = {"bound": 0, "pending": 0, "gone": 0}
        infos = self.queue.pending_pod_infos()
        # read-back strategy: per-pod authoritative gets for a small
        # backlog, ONE authoritative store list for a large one (a 10k-pod
        # failover must not pay 10k sequential store-lock round-trips
        # before the scheduling loop starts — promotion latency is the
        # whole point of the warm standby). `.store` unwraps a Cacher to
        # the raw store; a cache-served list could lag the dead leader's
        # final bind events.
        by_key = None
        if len(infos) > 64:
            try:
                pods, _ = getattr(self.server, "store", self.server).list(
                    "pods"
                )
                by_key = {p.metadata.key: p for p in pods}
            except Exception:
                logger.exception(
                    "adoption bulk read-back failed; per-pod fallback"
                )
        for pi in infos:
            pod = pi.pod
            try:
                if by_key is not None:
                    cur = by_key.get(pod.metadata.key)
                    if cur is not None and cur.metadata.uid != pod.metadata.uid:
                        cur = None  # same name, different pod: ours is gone
                else:
                    cur = self._read_back_pod(pod)
            except Exception:
                # store unreachable mid-promotion: leave the pod queued —
                # normal scheduling plus the ride-through buffer own it
                logger.exception(
                    "adoption read-back failed for %s; leaving queued",
                    pod.metadata.key,
                )
                continue
            # deletes are uid-guarded: the informer runs concurrently, and
            # a pod deleted+recreated between our queue snapshot and this
            # read-back must not lose its FRESH queue entry to a stale key
            if cur is None:
                self.queue.delete_if_uid(pod)
                tracer.discard(pi.trace_id)
                outcome = "gone"
            elif cur.spec.node_name:
                # the dead leader's bind landed: finish it — the cache
                # (and therefore the device snapshot) takes the placement,
                # the queue forgets the pod, and it is never re-placed
                self.queue.delete_if_uid(pod)
                self.cache.add_pod(cur)
                tracer.finish(
                    pi.trace_id, outcome="adopted", node=cur.spec.node_name
                )
                outcome = "bound"
            else:
                outcome = "pending"
            counts[outcome] += 1
            metrics.inc(COUNTER_ADOPTIONS, {"outcome": outcome})
        if self._ridethrough.depth:
            # leftover parked binds from this process's previous stint:
            # same read-back discipline, the reopen reconciler already
            # implements it
            self._reconcile_pending_binds()
        return counts

    def _auto_pipeline_depth(self) -> int:
        """Pick the wave-pipeline depth from the measured device->host
        readback RTT: a device whose every sync crosses a slow link wants
        the deep pipeline so one readback amortizes over many batches; a
        local card or the CPU wants the shallow one — deep pipelining there
        only adds pod latency. The probe's errors propagate: a device that
        cannot do a 64-byte round-trip must not start scheduling."""
        d = torch.zeros(16, dtype=torch.float32, device=self.device)
        (d + 1).cpu()  # warm-up: first use initializes the context
        rtts = []
        for _ in range(3):
            r = d + 1
            t0 = time.monotonic()
            r.cpu()
            rtts.append(time.monotonic() - t0)
        rtt_ms = sorted(rtts)[1] * 1e3
        # depth 2 unless the link is slow enough that one readback must
        # amortize over many batches
        return 6 if rtt_ms > 25.0 else 2

    def stop(self) -> None:
        self._stop.set()
        self._stop_standby_loop()
        if self._auditor is not None:
            self._auditor.stop()
            # no audit pass may run on after stop() returns
            t = self._auditor._thread
            if t is not None:
                t.join(timeout=10.0)
        self.queue.close()
        self.cache.stop()
        self.informer_factory.stop()
        # join the scheduling loop FIRST: a cycle still running could park
        # new permit-waiters after the reject sweep below, or submit binds
        # into a shut-down pool
        if self._sched_thread is not None:
            self._sched_thread.join(timeout=10.0)
        # outstanding trailing readbacks hold generation pins; consume
        # them (the loop is dead, so nobody else will release them)
        if self._trailing:
            self._drain_trailing(block=True)
        if self._owned_read_cache is not None:
            self._owned_read_cache.stop()
        if self._hostcb is not None:
            self._hostcb.close()
        # release parked permit-waiters or the drain below would block on
        # their (up to 30s) wait timeouts
        for p in self.profiles.values():
            for wp in p.framework.iterate_waiting_pods():
                wp.reject("scheduler shutting down")
        # drain in-flight binds BEFORE flushing recorders: a bind finishing
        # after the flush would drop its Scheduled event into a buffer
        # nobody serves
        self._bind_pool.shutdown(wait=True)
        for p in self.profiles.values():
            rec = getattr(p, "recorder", None)
            if rec is not None and hasattr(rec, "flush"):
                rec.flush(timeout=2.0)
                rec.stop()

    def wait_for_idle(self, timeout: float = 30.0) -> bool:
        """Test helper: wait until no pending pods remain. Requires the
        idle condition to hold across two samples so the scheduling loop's
        pop->launch gap (queue drained, batch not yet in flight) can't be
        mistaken for quiescence."""

        def idle() -> bool:
            # breaker open counts as busy even at depth 0: drain() zeroes
            # the depth for the whole reconcile pass, and entries may yet
            # be restored — the breaker only resets after a full drain
            return (
                len(self.queue) == 0
                and not self._pending
                and not self._trailing
                and not self._busy
                and not self._ridethrough.open
                and self._ridethrough.depth == 0
                and not self.cache.encoder.has_pending_updates
            )

        deadline = time.time() + timeout
        while time.time() < deadline:
            if idle():
                time.sleep(0.02)
                if idle():
                    return True
                continue
            time.sleep(0.01)
        return (
            len(self.queue) == 0
            and not self._pending
            and not self._busy
            and not self._ridethrough.open
            and self._ridethrough.depth == 0
        )

    # -- the loop ------------------------------------------------------------

    def _mark_busy(self) -> None:
        self._busy = True

    def _scheduling_loop(self) -> None:
        while not self._stop.is_set():
            # Circuit breaker: the store refused binds with a retryable
            # 503. Pause batch dispatch (informers, queue, and the HBM
            # snapshot stay warm) and probe for recovery; the queue keeps
            # accumulating instead of failing waves into unschedulableQ.
            if self._ridethrough.open:
                self._ride_through_degraded()
                continue
            # Batch-fill policy: the wave kernel's cycle cost is nearly
            # batch-size-independent (per-wave [TPL, N] work dominates), so
            # burst throughput = fill per kernel. With a batch in flight and
            # a MID-SIZE backlog queued (more than the small-bucket pad,
            # less than a full batch), resolve the in-flight batch FIRST:
            # its readback + bind work overlaps the device compute, and the
            # burst keeps accumulating toward a full batch instead of being
            # split into runt kernels (a 267-pod launch pays the same
            # ~cycle as a 4096-pod one). A full queue keeps the eager
            # depth-N pipeline exactly as before; with nothing in flight
            # don't block or linger — a lone low-load pod ships immediately.
            #
            # BELOW the small-bucket pad the batch is a runt either way, so
            # waiting a cycle to fatten it only adds latency: launch NOW and
            # let the new batch chain on the in-flight one's donated
            # generation (the launch path resolves the oldest batch right
            # after dispatch, so its compute overlaps the readback + binds).
            # This is the trickle-load payoff of the generational pipeline —
            # steady-state pod latency drops from ~2 wave cycles (wait out
            # the in-flight batch, then pay your own) to ~1 — and it only
            # became safe when wave launches stopped serializing against
            # audits/what-ifs on the device lock.
            backlog = self.queue.active_len()
            if (
                self._pending
                and self._small_bucket < backlog < self._batch_size
            ):
                self._busy = True
                try:
                    self._resolve_pending()
                except Exception:
                    # _resolve_oldest's contract is "never raises", but a
                    # failure here must degrade to a logged skip, not kill
                    # the scheduling thread for the life of the process
                    logger.exception("early batch resolve failed")
                finally:
                    self._busy = False
            inflight = bool(self._pending)
            # on_first marks the loop busy UNDER the queue lock before the
            # first pod leaves the queue, so wait_for_idle can never
            # observe "queue empty, nothing in flight" while a popped
            # batch is still on its way into the pipeline
            pis = self.queue.pop_batch(
                self._batch_size,
                timeout=0.0 if inflight else 0.2,
                window=0.0 if inflight else self.cfg.device_batch_window,
                on_first=self._mark_busy,
            )
            if not pis:
                if self._pending:
                    # stay busy across the drain: _resolve_oldest detaches
                    # the in-flight batches before the readback, so without
                    # this an observer would see "queue empty, nothing
                    # pending" while placements are still being replayed
                    self._busy = True
                    try:
                        self._resolve_pending()
                    finally:
                        self._busy = False
                elif self._trailing:
                    # idle with trailing bulk readbacks outstanding:
                    # consume them now (blocking — nothing else to do)
                    # so late validation can't dangle past quiescence
                    self._busy = True
                    try:
                        self._drain_trailing(block=True)
                    finally:
                        self._busy = False
                else:
                    self._busy = False
                continue
            try:
                self.schedule_pod_batch(pis)
            except Exception:
                logger.exception("scheduling batch failed")
                moves = self.queue.moves_snapshot()
                for pi in pis:
                    self.queue.add_unschedulable_if_not_present(pi, moves)
            finally:
                self._busy = False

    # -- degraded-store ride-through (ridethrough.py) -------------------------

    def _ride_through_degraded(self) -> None:
        """Breaker-open tick: flush in-flight wave batches (their binds
        buffer too — the kernels already committed on-device), wait one
        jittered probe interval, then try to drain the pending-bind
        buffer. The breaker closes only when the buffer fully drains."""
        if self._pending:
            self._busy = True
            try:
                self._resolve_pending()
            except Exception:
                logger.exception("degraded-mode pipeline flush failed")
            finally:
                self._busy = False
        if self._stop.wait(self._ridethrough.next_probe_delay()):
            return
        # cheap introspection first: an in-process store exposes its write
        # gate — while it still reports degraded, skip the write probe
        gate = getattr(self.server, "write_gate", None)
        if gate is not None and getattr(gate, "degraded", False):
            return
        if self._reconcile_pending_binds():
            self._ridethrough.reset()
            logger.warning(
                "store writes reopened: pending-bind buffer drained, "
                "resuming batch dispatch"
            )

    def _buffer_pending_binds(self, entries: List[PendingBind]) -> None:
        accepted, overflow = self._ridethrough.buffer(entries)
        if accepted:
            for e in accepted:
                tracer.event(e.pi.trace_id, "bind.parked")
            logger.warning(
                "store degraded: buffered %d pending binds "
                "(dispatch paused until writes reopen)", len(accepted),
            )
        for e in overflow:
            # bounded buffer: past capacity the placement unwinds like a
            # failed bind — backoff retries it once the store recovers
            self.cache.forget_pod(e.pi.pod)
            self._release_permits(e.pi.pod)
            self.queue.requeue_backoff(e.pi)

    def _reconcile_pending_binds(self) -> bool:
        """Drain the pending-bind buffer against the (possibly recovered)
        store. Each pod is read back FIRST: an applied-but-unacked bind
        (QuorumLost) must be detected, never blindly replayed — and the
        retry itself is uid-fenced by the store's binding check, so a
        duplicated attempt can never double-bind. Returns True when the
        buffer fully drained."""
        entries = self._ridethrough.drain()
        if not entries:
            return True
        still_degraded: List[PendingBind] = []
        for e in entries:
            if still_degraded:
                # store went (or stayed) degraded mid-pass: keep the rest
                # buffered untouched for the next probe
                still_degraded.append(e)
                continue
            try:
                self._reconcile_one(e, still_degraded)
            except Exception:
                # anything unclassified (REST connection refused mid-
                # failover, NotPrimary, ...): the store is not usable yet.
                # Keep the entry — and the scheduling thread — alive; the
                # next probe retries.
                logger.exception(
                    "pending-bind reconcile failed for %s; retrying later",
                    e.pi.pod.metadata.key,
                )
                still_degraded.append(e)
        if still_degraded:
            self._ridethrough.restore(still_degraded)
            return False
        return True

    def _read_back_pod(self, pod: v1.Pod):
        """Authoritative store read-back, uid-fenced: the current object
        for pod's key, or None when it is gone — including the same-name-
        different-pod case (ours was deleted and the name reused). Shared
        by the reopen reconciler and the leader-adoption pass so their
        outcome semantics cannot drift."""
        try:
            cur = self.server.get(
                "pods", pod.metadata.namespace, pod.metadata.name
            )
        except NotFound:
            return None
        if cur.metadata.uid != pod.metadata.uid:
            return None  # same name, different pod: ours is gone
        return cur

    def _reconcile_one(
        self, e: PendingBind, still_degraded: List[PendingBind]
    ) -> None:
        pod = e.pi.pod

        def outage_span() -> None:
            # the parked bind's whole outage wait is a first-class span:
            # a pod that rode through a degraded store shows WHERE the
            # seconds went instead of an unexplained e2e tail
            tracer.add_span(
                e.pi.trace_id, "outage.wait", e.buffered_at, time.monotonic()
            )

        cur = self._read_back_pod(pod)
        if cur is None:
            # deleted while buffered, or lost with a failed primary
            self.cache.forget_pod(pod)
            self._release_permits(pod)
            metrics.inc(COUNTER_RECONCILED, {"outcome": "gone"})
            tracer.discard(e.pi.trace_id)
            return
        if cur.spec.node_name:
            if cur.spec.node_name == e.node_name:
                # the bind LANDED — only its ack was lost
                outage_span()
                self._record_bound(
                    e.pi, e.node_name, e.profile, outcome="landed"
                )
            else:
                # bound elsewhere (another path won): drop our assume;
                # the informer's scheduled-add owns the cache entry
                self.cache.forget_pod(pod)
                self._release_permits(pod)
                metrics.inc(COUNTER_RECONCILED, {"outcome": "foreign"})
                tracer.finish(e.pi.trace_id, outcome="foreign")
            return
        # not bound: the write never applied (or didn't survive
        # failover) — replay once, uid-fenced
        binding = Binding(
            pod_name=pod.metadata.name,
            pod_namespace=pod.metadata.namespace,
            pod_uid=pod.metadata.uid,
            target_node=e.node_name,
        )
        try:
            errs = self._bind_pods_fenced([binding])
            err = errs[0] if errs else None
        except DegradedWrites as exc:
            err = exc
        except LeaderFenced:
            # deposed mid-reconcile: the replay belongs to the new leader
            self._on_fenced_binds([e.pi])
            return
        if isinstance(err, DegradedWrites):
            still_degraded.append(e)
        elif err is None:
            outage_span()
            self._record_bound(
                e.pi, e.node_name, e.profile, outcome="rebound"
            )
        elif isinstance(err, NotFound):
            # deleted between the read-back and the replay: same as gone —
            # requeueing would park a ghost in unschedulableQ forever (its
            # informer delete already fired)
            self.cache.forget_pod(pod)
            self._release_permits(pod)
            metrics.inc(COUNTER_RECONCILED, {"outcome": "gone"})
            tracer.discard(e.pi.trace_id)
        else:
            self.cache.forget_pod(pod)
            metrics.inc(COUNTER_RECONCILED, {"outcome": "lost_requeued"})
            self._handle_failure(
                e.pi, self.queue.moves_snapshot(), message=str(err), error=True
            )

    def _bind_pods_fenced(self, bindings) -> list:
        """Every scheduler-originated batch bind funnels here: when a
        leadership fence is armed (promote(fence=...)), the token rides
        along and the store rejects the whole batch with LeaderFenced if
        this process's grant has been superseded. Callers own the
        DegradedWrites / LeaderFenced handling."""
        if self._bind_fence is not None:
            return self.server.bind_pods(bindings, fence=self._bind_fence)  # graftlint: degraded-ok(fence-attaching seam; both callers catch DegradedWrites/LeaderFenced at their call sites)
        return self.server.bind_pods(bindings)  # graftlint: degraded-ok(fence-attaching seam; both callers catch DegradedWrites/LeaderFenced at their call sites)

    def _check_fence_live(self) -> None:
        """Best-effort fence pre-check for bind writes the store cannot
        validate atomically — an extender binds OUT OF PROCESS, so the
        only check available is re-reading the lease just before handing
        it the pod. Raises LeaderFenced when this replica's grant was
        superseded; an unreadable lease (degraded store, REST blip) lets
        the bind proceed — the pre-check narrows the zombie window, the
        store-validated fence on every in-tree bind closes it."""
        f = self._bind_fence
        if f is None:
            return
        try:
            lease = self.server.get("leases", f.namespace, f.name)
        except NotFound:
            lease = None
        except Exception:
            return
        if (
            lease is None
            or lease.holder_identity != f.identity
            or lease.lease_transitions != f.transitions
        ):
            raise LeaderFenced(
                f"extender bind fenced: lease {f.namespace}/{f.name} now "
                f"held by {getattr(lease, 'holder_identity', None)!r} at "
                f"transition {getattr(lease, 'lease_transitions', None)} "
                f"(caller's token: {f.identity!r} at {f.transitions})"
            )

    def check_eviction_fence(self) -> None:
        """Public fence seam for out-of-pipeline evictors (the
        descheduler): plain pod deletes/evictions are store writes with
        no atomic fence validation, so a consolidation wave re-reads the
        lease through the same best-effort pre-check preemption victim
        deletes use. Raises LeaderFenced when this replica's grant was
        superseded; no-op when no fence is armed (single-replica rigs)."""
        self._check_fence_live()

    def fragmentation_score(self) -> float:
        """Stranded-capacity fragmentation of the LIVE fleet: free
        capacity sitting on partially-used nodes / total free capacity,
        from the encoder's host masters (ops/encoding.utilization_stats)
        through the same arithmetic the tuner scores replayed waves with
        (tuner/scoring.fragmentation_score). Published as the
        scheduler_fragmentation_score gauge — the descheduler's planning
        signal and the policy gym's consolidation actuator: one
        definition, three consumers."""
        from ..tuner.scoring import fragmentation_score as _frag

        with self.cache.lock:
            st = self.cache.encoder.utilization_stats()
        score = _frag(st.free_frac, st.used_any, st.valid)
        metrics.set_gauge("scheduler_fragmentation_score", score)
        return score

    def _on_fenced_binds(self, entries) -> None:
        """We are a zombie ex-leader: a newer grant exists and the store
        refused our binds. Drop the placements (the new leader owns these
        pods now — re-placing or requeueing them here would just race it)
        and count, so the chaos ledger can prove zero double-binds."""
        metrics.inc(
            COUNTER_FENCED_BINDS,
            {"path": self._bind_transport},
            by=float(len(entries)),
        )
        logger.error(
            "bind batch of %d rejected by the leadership fence: this "
            "scheduler (%s) has been superseded; dropping the placements",
            len(entries), self._ha_identity,
        )
        for pi in entries:
            # the zombie's view of its own fencing: the store-side stamp
            # under the same id is recorded by the store process
            tracer.event(pi.trace_id, "bind.fenced")
            tracer.finish(pi.trace_id, outcome="fenced")
            self.cache.forget_pod(pi.pod)
            self._release_permits(pi.pod)

    def _release_permits(self, pod: v1.Pod) -> None:
        """Unwind paths that drop a buffered placement without a full
        _handle_failure must still tell permit plugins the pod is gone —
        a gang-quorum plugin may hold siblings parked on its reservation
        (the same hook _handle_failure fires)."""
        prof = self.profiles.for_pod(pod)
        if prof is None:
            return
        for name in prof.framework.plugin_set.permit:
            hook = getattr(
                prof.framework.plugin(name), "handle_scheduling_failure", None
            )
            if hook is not None:
                try:
                    hook(pod)
                except Exception:
                    logger.exception("permit release hook %s", name)

    def _record_bound(
        self, pi: QueuedPodInfo, node_name: str, prof, outcome: Optional[str] = None
    ) -> None:
        """Post-bind bookkeeping shared by the in-cycle bulk path and the
        ride-through reconciler."""
        self.cache.finish_binding(pi.pod)
        metrics.observe(
            "pod_scheduling_duration_seconds",
            time.monotonic() - pi.initial_attempt_timestamp,
            exemplar=pi.trace_id or None,
        )
        metrics.inc("schedule_attempts_total", {"result": "scheduled"})
        tracer.finish(pi.trace_id, outcome=outcome or "bound", node=node_name)
        if outcome:
            metrics.inc(COUNTER_RECONCILED, {"outcome": outcome})
        prof.recorder.eventf(
            pi.pod, "Normal", "Scheduled", "Binding",
            f"Successfully assigned {pi.pod.metadata.key} to {node_name}",
        )

    def schedule_pod_batch(self, pis: List[QueuedPodInfo]) -> None:
        trace = Trace("schedule_batch", pods=len(pis))
        t_start = time.monotonic()
        # close every pod's queue-wait span (last queue ENTRY -> cycle
        # start) in ONE ring acquisition; requeued pods accumulate one
        # `queue` span per attempt, which is the honest attribution
        # (trace_queued_at, not timestamp: readd() refreshes only the
        # former — see QueuedPodInfo)
        tracer.add_spans(
            [(pi.trace_id, "queue", pi.trace_queued_at, t_start)
             for pi in pis]
        )
        moves0 = self.queue.moves_snapshot()
        known: List[QueuedPodInfo] = []
        extender_pis: List[QueuedPodInfo] = []
        for pi in pis:
            if self.profiles.for_pod(pi.pod) is None:
                logger.error(
                    "no profile for scheduler name %s", pi.pod.spec.scheduler_name
                )
                continue
            # extender-interested pods need the host path: an out-of-process
            # veto can't be folded into the device mask
            if any(e.is_interested(pi.pod) for e in self.extenders):
                extender_pis.append(pi)
                continue
            known.append(pi)
        if extender_pis:
            # host path reads the host cache: in-flight replays must land
            self._resolve_pending()
        for pi in extender_pis:
            # _schedule_one_host re-snapshots per pod
            self._schedule_one_host(pi, moves0)
        if not known:
            return
        # the device-down latch (unrecoverable device loss) degrades every
        # batch to the host path — correctness over throughput
        use_device = self.cfg.use_device and not self._device_down
        if (
            0 < len(known) <= self.cfg.small_batch_host_max
            and self.cache.node_count <= self.cfg.small_batch_host_node_max
            and use_device
        ):
            # low-load latency path for SMALL clusters: a tiny batch on the
            # device path pays a full cycle (kernel + >=1 readback) for
            # a handful of pods, where the host scheduleOne over a small
            # cluster is cheap (snapshot clones are generation-incremental).
            # At thousands of nodes the Python filter chain is SLOWER than
            # the kernel — big clusters stay on the device path and get the
            # small-pad/m_cand variant instead. Device state stays
            # consistent: the host path resolves in-flight batches and its
            # binds dirty the encoder rows like any informer write.
            self._resolve_pending()
            for pi in known:
                self._schedule_one_host(pi, moves0)
            trace.log_if_long(0.1)
            return
        if use_device and self.cfg.use_wave:
            self._schedule_batch_wave(known, moves0, trace, t_start)
        elif use_device:
            self._resolve_pending()
            self._schedule_batch_device(known, moves0, trace, t_start)
            trace.log_if_long(0.1)
        else:
            self._resolve_pending()
            self._snapshot = self.cache.update_snapshot()
            for pi in known:
                self._schedule_one_host(pi, moves0)
            trace.log_if_long(0.1)

    # -- device path ---------------------------------------------------------

    @staticmethod
    def _pad(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def _schedule_batch_device(
        self, pis: List[QueuedPodInfo], moves0: int, trace: Trace, t_start: float
    ) -> None:
        """The serial device path (use_wave=False): encode the batch per
        pod, run the serial lattice, read it back, then assume and bind."""
        # device-loss ride-through, serial-path edition (launch+readback
        # are one synchronous call here): bounded jittered retries, then
        # the _handle_device_loss ladder (transient re-upload / latch
        # off) and the host path for this batch — nothing is assumed
        # before the readback succeeds, so quarantining loses zero pods.
        # Each attempt re-encodes AND re-flushes under the lock: informer
        # churn during the retry sleep can remap encoder rows, and a stale
        # eb/row_names would decode the kernel's row choices against the
        # wrong nodes (same reason the wave wrapper re-encodes per retry).
        attempts = 0
        while True:
            with self.cache.lock, _stage_timer("encode"):
                eb = encode_pod_batch(
                    self.cache.encoder,
                    [pi.pod for pi in pis],
                    pad_to=self._pad(len(pis)),
                )
                snap = self.cache.encoder.flush()
                enc_cfg = self.cache.encoder.cfg
                row_names = list(self.cache.encoder.row_names)
                launch_gen = self.cache._ext_generation
            trace.step("encoded+flushed")
            kern = self._serial_kernel(enc_cfg.v_cap)
            rng_key = self._noise_key(self._serial_noise)
            noise = self._serial_noise(
                int(eb.batch.valid.shape[0]), num_rows(snap)
            )
            w_launch = np.asarray(self._weights)
            try:
                with _stage_timer("kernel"):
                    res, chosen, score, bulk = self._run_serial_kernel(
                        kern, snap, eb.batch, noise, w_launch
                    )
                self._consecutive_device_loss = 0
                break
            except Exception as e:  # noqa: BLE001 — classifier filters
                if not is_device_loss_error(e):
                    raise
                with self.cache.lock:
                    self.cache.encoder.invalidate_device()
                # same metric semantics as launch/readback: recovered
                # blips count as retries, loss_total only on terminal
                if attempts < self.cfg.device_retry_attempts:
                    attempts += 1
                    metrics.inc(
                        "scheduler_device_retries_total",
                        {"stage": "serial"},
                    )
                    delay = device_retry_delay(attempts)
                    logger.warning(
                        "device loss on serial batch kernel (%s); retry "
                        "%d/%d in %.0f ms with a fresh encode + snapshot "
                        "upload",
                        e, attempts, self.cfg.device_retry_attempts,
                        delay * 1e3,
                    )
                    time.sleep(delay)
                    continue
                metrics.inc(
                    "scheduler_device_loss_total", {"stage": "serial"}
                )
                logger.error(
                    "device loss on serial batch kernel persists after "
                    "%d retries (%s): batch of %d pods degrades to the "
                    "host path", attempts, e, len(pis),
                )
                self._handle_device_loss(e)
                self._snapshot = self.cache.update_snapshot()
                for pi in pis:
                    self._schedule_one_host(pi, moves0)
                return
        trace.step("kernel")
        algo_dur = time.monotonic() - t_start
        if self.cfg.kernel_output_guards:
            # mask with `!= -1`, not `>= 0`: -1 is the kernel's ONLY
            # legitimate unplaced sentinel, so any other negative index
            # is corruption that must trip GUARD_ROW_RANGE — a `>= 0`
            # mask would silently route a sign-flipped row (and its
            # poisoned score) into the unschedulable/preemption path
            reason = validate_batch_outputs(
                chosen, np.asarray(chosen) != -1, score, len(row_names)
            )
            if reason:
                # serial path (no pipeline): quarantine this batch to the
                # host path and rebuild the snapshot — nothing assumed yet
                metrics.inc("kernel_guard_trips_total", {"reason": reason})
                logger.error(
                    "kernel output guard tripped (%s) on the serial device "
                    "path: batch of %d pods degrades to the host path",
                    reason, len(pis),
                )
                with self.cache.lock:
                    self.cache.encoder.invalidate_device()
                # a persistently poisoned device must latch OFF here too,
                # not loop launch → trip → full re-upload per batch forever
                self._consecutive_guard_trips += 1
                if (
                    self._consecutive_guard_trips
                    >= self.cfg.device_loss_disable_after
                ):
                    logger.error(
                        "%d consecutive kernel guard trips: abandoning the "
                        "device path for the host path",
                        self._consecutive_guard_trips,
                    )
                    self._set_device_down()
                self._snapshot = self.cache.update_snapshot()
                for pi in pis:
                    self._schedule_one_host(pi, moves0)
                return
            self._consecutive_guard_trips = 0

        fallback_pis: List[QueuedPodInfo] = []
        failed: List = []  # (pi, batch_index or -1)
        resolvable = None
        serial_placed: dict = {}  # id(pi) -> node (tuner wave record)
        serial_to_bind: List = []  # (pi, node_name) decode-first, bind after
        for i, pi in enumerate(pis):
            if eb.fallback[i]:
                fallback_pis.append(pi)
                continue
            row = int(chosen[i])
            if row < 0:
                if resolvable is None:
                    resolvable = res.resolvable.cpu().numpy()
                failed.append((pi, i))
                continue
            node_name = row_names[row]
            if node_name is None:
                failed.append((pi, -1))
                continue
            serial_to_bind.append((pi, node_name))
        # split-phase serial: the fast chosen-index payload was acted on
        # with score=None; register the trailing bulk validation before
        # any bind leaves the process, and take one last non-blocking
        # look — on CPU the score has already landed, so the common case
        # still validates before the first bind
        entry = None
        if bulk is not None and serial_to_bind:
            entry = self._register_trailing(
                bulk,
                np.asarray(chosen) != -1,
                [(pi, node, None, None) for pi, node in serial_to_bind],
                launch_gen, None, path="serial",
            )
        if entry is not None and self._trailing_gate(entry):
            for pi, _node in serial_to_bind:
                tracer.event(pi.trace_id, "serial.trailing_unwound")
                self.queue.requeue_backoff(pi)
        else:
            for pi, node_name in serial_to_bind:
                metrics.observe(
                    "scheduling_algorithm_duration_seconds", algo_dur
                )
                self._assume_and_bind(pi, node_name, t_start)
                serial_placed[id(pi)] = node_name
            if entry is not None:
                entry.binds_issued = True
        self._record_wave_for_tuner(
            pis, serial_placed, w_launch, rng_key, launch_gen, path="serial"
        )
        if fallback_pis or failed:
            self._snapshot = self.cache.update_snapshot()
        for pi in fallback_pis:
            self._schedule_one_host(pi, moves0)
        if failed:
            # one batched device what-if narrows every failed pod's candidates
            whatif = None
            try:
                with self.cache.lock:
                    snap2 = self.cache.encoder.flush()
                whatif = preempt_whatif(
                    gather_snapshot(snap2), eb.batch, eb.batch.priority
                ).cpu().numpy()
            except Exception:
                logger.exception("preempt what-if kernel failed")
            for pi, i in failed:
                # i < 0: decode anomaly (node vanished mid-cycle) — pass
                # None so the preemptor does its own full scan
                candidates: Optional[List[str]] = None
                if i >= 0 and resolvable is not None:
                    mask = resolvable[i]
                    # shapes can differ if a node joined between the batch
                    # encode and the what-if re-flush (encoder row growth)
                    if whatif is not None and whatif.shape[1] == mask.shape[0]:
                        mask = mask & whatif[i]
                    candidates = [
                        row_names[r]
                        for r in np.nonzero(mask)[0]
                        if row_names[r]
                    ]
                self._handle_failure(
                    pi,
                    moves0,
                    message=f"0/{self.cache.node_count} nodes are available",
                    candidate_nodes=candidates,
                )

    def _run_serial_kernel(self, kern, snap, batch, noise, weights=None):
        """Launch + readback of the serial batch kernel — one synchronous
        call, split out as an injectable seam for fault injection (mirrors
        _launch_wave_kernel/_fetch_wave_index). ``weights`` pins the exact
        launch vector; None reads the live policy. Returns (res, chosen,
        score, bulk).

        Split-phase mode: only the small chosen-index vector is fetched
        on the critical path (its device->host copy starts on the side
        stream right behind the launch); the score tensor streams back
        behind it (``bulk``, a HostCopy) and is validated by the trailing
        machinery — the caller sees score=None and registers a
        _TrailingReadback. Combined mode returns both as numpy and bulk
        None."""
        if weights is None:
            weights = np.asarray(self._weights)
        res = kern(snap, batch, weights, noise)
        if self._split_phase:
            with self.cache.encoder.pin_generation():
                fast = HostCopy((res.chosen,), self._copy_stream)
                bulk = HostCopy((res.score,), self._copy_stream)
                metrics.inc(COUNTER_WAVE_BLOCKING_READBACKS)
                chosen = fast.arrays()[0]
            return res, chosen, None, bulk
        return res, res.chosen.cpu().numpy(), res.score.cpu().numpy(), None

    # -- wave device path -----------------------------------------------------

    def _pair_table(self, eb):
        """Pair table cached by (template set, vocab) signature. The wave
        count is derived separately per batch (_batch_waves)."""
        enc = self.cache.encoder
        sig = (
            eb.num_templates,
            # rows_gen distinguishes DIFFERENT template sets that happen
            # to share count + vocab sizes (the >max_templates churn
            # rebuild re-registers from one batch without growing any
            # vocab) — a stale pair table would enforce the wrong pairs
            self._tpl_cache.rows_gen,
            self._tpl_cache._vocab_sig,
            len(enc.sel_vocab),
            len(enc.eterm_vocab),
        )
        if self._pair_cache is not None and self._pair_cache[0] == sig:
            return self._pair_cache[1]
        table, overflow = build_pair_table(enc, eb.tpl_np, eb.num_templates)
        if overflow:
            logger.warning("pair table overflow; kernel capacity grew")
        self._pair_cache = (sig, table)
        return table

    def _batch_waves(self, eb) -> tuple:
        """(wave count, has_hard) for THIS batch, from the templates
        actually present in it (NOT the whole accumulated template cache —
        one historical hard-pair template must not pin every later
        soft-only burst to the full wave count). No-hard batches:
        prefix-fit packing commits many pods per node per wave, so
        conflicts drain in 1-2 waves even at 4096-pod bursts; losers
        defer and retry next batch. Measured (reference, CPU 5k nodes,
        PodAffinity): 2 waves 2020 pods/s vs 4 waves 1602, all scheduled,
        same batch count. Hard-pair batches keep the configured count —
        and get the per-wave score refresh regardless of backend (see
        _schedule_batch_wave): without it the candidate columns chase
        batch-start domain counts while in-batch commits fill the
        low-count domains, and a 5k-node hard-spread storm was measured
        converging bimodally (7 vs 88 pods/s) on CPU."""
        return batch_waves(self.cache.encoder, eb, self.cfg.wave_n_waves)

    def _schedule_batch_wave(
        self, pis: List[QueuedPodInfo], moves0: int, trace: Trace, t_start: float
    ) -> None:
        """Device-loss ride-through wrapper around the wave launch:
        a launch that dies with a device-loss error gets bounded jittered
        retries — each retry re-encodes and re-flushes from the host
        masters (the failed launch may have consumed the donated snapshot,
        and node rows can move between attempts) — then falls through to
        _handle_device_loss (a probe of the card, or the host path).
        Nothing is assumed before a launch succeeds, so the requeue on
        give-up loses zero pods."""
        attempts = 0
        while True:
            try:
                self._schedule_batch_wave_once(pis, moves0, trace, t_start)
                self._consecutive_device_loss = 0
                return
            except Exception as e:  # noqa: BLE001 — classifier filters
                if not is_device_loss_error(e):
                    raise
                with self.cache.lock:
                    self.cache.encoder.invalidate_device()
                # metric semantics match the readback wrapper: a blip a
                # retry recovers from counts as a RETRY; loss_total is
                # reserved for terminal (ladder-escalating) losses
                if attempts < self.cfg.device_retry_attempts:
                    attempts += 1
                    metrics.inc(
                        "scheduler_device_retries_total",
                        {"stage": "launch"},
                    )
                    delay = device_retry_delay(attempts)
                    logger.warning(
                        "device loss on wave launch (%s); retry %d/%d "
                        "in %.0f ms with a fresh snapshot upload",
                        e, attempts, self.cfg.device_retry_attempts,
                        delay * 1e3,
                    )
                    time.sleep(delay)
                    continue
                metrics.inc(
                    "scheduler_device_loss_total", {"stage": "launch"}
                )
                logger.error(
                    "wave launch failed with device loss after %d retries: %s",
                    attempts, e,
                )
                self._handle_device_loss(e)
                for pi in pis:
                    self.queue.requeue_backoff(pi)
                return

    def _launch_wave_kernel(self, kern, snap, batch, ptab, weights, noise):
        """Seam for fault injection: every wave launch goes through here.
        Returns (new_snap, res, copies).

        The launch updates the snapshot tensors in place ("donates"), so
        it runs inside the encoder's donation lease: the lease seals the
        live generation — or, when a reader holds a pin on it, hands the
        kernel a fresh copy so the pinned tensors survive — and installs
        the kernel's output snapshot as the next generation. `snap` stays
        in the seam signature (the reference's injector reads it) but the
        lease's snapshot is authoritative.

        Split-phase: BOTH device->host copies start here, at dispatch,
        inside the lease: the few-KB index payload (chosen, placed,
        deferred) and, behind it, the bulk score for the trailing
        validation. `copies` is (index HostCopy, score HostCopy), or None
        in combined mode."""
        enc = self.cache.encoder
        with enc.donation_lease() as dl:
            new_snap, res = kern.with_noise(dl.snap, batch, ptab, weights, noise)
            copies = None
            if self._split_phase:
                # a host-callback launch already started the fast copy
                # (and handed it to the delivery thread)
                fast = getattr(kern, "fast", None) or HostCopy(
                    (res.chosen, res.placed, res.deferred), self._copy_stream
                )
                bulk = HostCopy((res.score,), self._copy_stream)
                copies = (fast, bulk)
            dl.result = new_snap
        return new_snap, res, copies

    def _fetch_wave_results(self, batches: List["_InFlightBatch"]):
        """Seam for fault injection: the combined device->host readback
        for k in-flight batches (the non-split-phase path) — one blocking
        copy per tensor."""
        metrics.inc(COUNTER_WAVE_BLOCKING_READBACKS)
        metrics.inc("scheduler_wave_readbacks_total")
        return [
            tuple(
                t.cpu().numpy()
                for t in (b.res.chosen, b.res.placed, b.res.deferred, b.res.score)
            )
            for b in batches
        ]

    def _fetch_wave_index(self, batches: List["_InFlightBatch"]):
        """Seam for fault injection: the split-phase FAST readback — just
        the index payload (chosen, placed, deferred) per batch. The async
        copy started at dispatch means this usually consumes an
        already-landed transfer; a host-callback ticket beats even that
        (the delivery thread already landed the payload in the registry).
        A fetch that finds a copy not yet landed (its event's query()
        still False: the resolve overtook the kernel) is a real
        host-blocking device sync and counts separately: it is the
        readbacks_per_bind numerator."""
        metrics.inc(COUNTER_WAVE_FAST_READBACKS)
        out: List = []
        for b in batches:
            payload = None
            if b.ticket is not None:
                payload = hostcallback.take(b.ticket, timeout=2.0)
                if payload is not None:
                    metrics.inc(COUNTER_WAVE_HOSTCB)
            out.append(payload)
        missing = [i for i, p in enumerate(out) if p is None]
        if missing:
            if not all(batches[i].copies[0].ready() for i in missing):
                metrics.inc(COUNTER_WAVE_BLOCKING_READBACKS)
                metrics.inc("scheduler_wave_readbacks_total")
            for i in missing:
                out[i] = batches[i].copies[0].arrays()
        return out

    def _fetch_wave_bulk(self, entries: List["_TrailingReadback"]):
        """Seam for fault injection: the split-phase TRAILING readback —
        the bulk score payload for registered trailing entries."""
        return [e.score.arrays()[0] for e in entries]

    # -- split-phase trailing validation --------------------------------------

    def _register_trailing(
        self, score, placed, to_bind, launch_gen, wave_tid, path="wave"
    ) -> "_TrailingReadback":
        """Register one batch's trailing bulk readback at fast commit.
        The entry pins the live generation (released when its readback
        lands) and the backlog is bounded: past trailing_readback_max the
        oldest entry is force-drained with a blocking fetch."""
        pin = None
        try:
            pin = self.cache.encoder.pin_generation().acquire()
        except Exception:
            # pin failure must not block the fast path — the unwind can
            # still invalidate + mark suspect rows without it
            logger.exception("trailing generation pin failed")
        entry = _TrailingReadback(
            score, np.asarray(placed, dtype=bool), list(to_bind),
            launch_gen, wave_tid, pin, path,
        )
        self._trailing.append(entry)
        overflow = len(self._trailing) - self.cfg.trailing_readback_max
        if overflow > 0:
            metrics.inc(COUNTER_WAVE_BLOCKING_READBACKS)
            self._drain_trailing(block=True, limit=overflow)
        metrics.set_gauge(
            GAUGE_WAVE_TRAILING_BACKLOG, float(len(self._trailing))
        )
        return entry

    def _trailing_gate(self, entry: "_TrailingReadback") -> bool:
        """Pre-bind gate (called by _assume_and_bind_bulk between assume
        and bind): consume whatever trailing payloads already landed —
        including this batch's own, when the kernel finished — and report
        whether THIS batch must unwind. Non-blocking: a slow tunnel's
        trailing payload is consumed on a later drain instead of stalling
        the bind-critical path."""
        entry.gated = True
        try:
            self._drain_trailing(block=False)
        finally:
            entry.gated = False
        return entry.quarantined

    def _drain_trailing(
        self, block: bool = False, limit: Optional[int] = None
    ) -> None:
        """Consume registered trailing readbacks, oldest first; never
        raises. block=False stops at the first entry whose bulk payload
        hasn't materialized yet."""
        n = 0
        while self._trailing:
            if limit is not None and n >= limit:
                break
            entry = self._trailing[0]
            if not block and not entry.quarantined and not entry.ready():
                break
            self._trailing.pop(0)
            n += 1
            try:
                self._consume_trailing(entry)
            except Exception:
                logger.exception("trailing readback consumption failed")
                self._release_trailing_pin(entry)
        metrics.set_gauge(
            GAUGE_WAVE_TRAILING_BACKLOG, float(len(self._trailing))
        )

    def _consume_trailing(self, entry: "_TrailingReadback") -> None:
        if entry.quarantined:
            # an elder sibling's trailing trip already condemned this
            # entry (same suspect snapshot chain): nothing to validate
            self._release_trailing_pin(entry)
            tracer.finish(entry.wave_tid, outcome="trailing_sibling")
            return
        t0 = time.monotonic()
        try:
            with _stage_timer("trailing"):
                score = call_with_device_retry(
                    lambda: self._fetch_wave_bulk([entry]),
                    attempts=self.cfg.device_retry_attempts,
                    on_retry=lambda n, e: metrics.inc(
                        "scheduler_device_retries_total",
                        {"stage": "trailing"},
                    ),
                )[0]
            metrics.inc(COUNTER_WAVE_TRAILING_READBACKS)
        except Exception as e:
            logger.exception("trailing bulk readback failed")
            if is_device_loss_error(e):
                metrics.inc(
                    "scheduler_device_loss_total", {"stage": "trailing"}
                )
            self._unwind_trailing(entry, GUARD_TRAILING_LOSS, str(e))
            return
        finally:
            self._release_trailing_pin(entry)
        reason = None
        if self.cfg.kernel_output_guards:
            reason = validate_trailing_score(score, entry.placed)
        if reason is not None:
            self._unwind_trailing(entry, reason)
            return
        self._consecutive_guard_trips = 0
        t1 = time.monotonic()
        tracer.add_span(entry.wave_tid, "trailing", t0, t1)
        tracer.finish(entry.wave_tid, outcome="committed")

    def _release_trailing_pin(self, entry: "_TrailingReadback") -> None:
        pin, entry.pin = entry.pin, None
        if pin is not None:
            try:
                pin.release()
            except Exception:
                logger.exception("trailing generation pin release failed")

    def _unwind_trailing(
        self, entry: "_TrailingReadback", reason: str, detail: str = ""
    ) -> None:
        """The trailing bulk payload disagrees with (or never reached)
        the fast index payload the batch already acted on. Quarantine:
        count the trip, mark every row the fast payload committed into
        suspect (the anti-entropy auditor re-checks + repairs them from
        the host masters), force a device snapshot rebuild, and condemn
        every younger trailing entry (their kernels chained on the same
        suspect snapshot). If this batch's binds have NOT left the
        process yet (the pre-bind gate caught it), revert its assumes
        and requeue — zero wrong bindings; already-bound pods passed the
        fast-phase row/oracle guards and stay."""
        entry.quarantined = True
        metrics.inc("kernel_guard_trips_total", {"reason": reason})
        logger.error(
            "trailing readback validation tripped (%s%s): batch "
            "quarantined, snapshot rebuild forced%s",
            reason, f" {detail}" if detail else "",
            "" if entry.binds_issued else "; assumes unwound",
        )
        with self.cache.lock:
            enc = self.cache.encoder
            for _pi, node_name, _band, _proto in entry.to_bind:
                row = enc._row_by_name.get(node_name)
                if row is not None:
                    enc.suspect_rows.add(row)
            enc.invalidate_device()
        if not entry.binds_issued and not entry.gated:
            for pi, _node, _band, _proto in entry.to_bind:
                try:
                    self.cache.forget_pod(pi.pod)
                except Exception:
                    logger.exception("trailing unwind forget failed")
                metrics.inc(COUNTER_WAVE_TRAILING_UNWOUND)
                tracer.event(pi.trace_id, "wave.trailing_unwound")
                self.queue.requeue_backoff(pi)
        tracer.finish(entry.wave_tid, outcome=f"trailing_trip:{reason}")
        for e in self._trailing:
            if not e.quarantined:
                e.quarantined = True
                metrics.inc(
                    "kernel_guard_trips_total",
                    {"reason": "sibling_quarantine"},
                )
        self._consecutive_guard_trips += 1
        if (
            self._consecutive_guard_trips
            >= self.cfg.device_loss_disable_after
        ):
            logger.error(
                "%d consecutive kernel guard trips: abandoning the "
                "device path for the host path",
                self._consecutive_guard_trips,
            )
            self._set_device_down()

    def _schedule_batch_wave_once(
        self, pis: List[QueuedPodInfo], moves0: int, trace: Trace, t_start: float
    ) -> None:
        """Launch the wave kernel for this batch; resolve the PREVIOUS
        in-flight batch while this one computes (depth-1 pipeline)."""
        # consume any trailing bulk payload that already landed BEFORE the
        # donation below: draining releases the entries' generation pins,
        # so the steady-state launch donates in place instead of paying a
        # copy-on-pin snapshot clone every wave
        if self._trailing:
            self._drain_trailing(block=False)
        # two padded-batch buckets: ragged tails use a small lattice with a
        # narrow candidate list (per-wave cost scales with m_cand, and a
        # 1-pod low-load cycle should not pay the list sized for 4096-pod
        # bursts), bursts the full one (wavepath.wave_bucket)
        pad, small_bucket, m_cand = wave_bucket(
            len(pis), self._batch_size, self._small_bucket, self._m_cand,
            self.cfg.wave_m_cand_small,
        )
        # encode → drain-check → flush must be ATOMIC under the cache lock:
        # a dirty-row scatter uploads full rows from the host masters, which
        # must already include the in-flight batch's replayed placements or
        # the scatter would erase its on-device commits; and the pod batch's
        # node-row references must be captured under the same lock as the
        # snapshot they index (node remove+re-add can reuse a row). Draining
        # happens OUTSIDE the lock (readback + binds), then re-encode.
        # cheap pre-check so the common drain case pays one encode, not two
        # (the locked re-check below remains authoritative: encode itself
        # can intern predicates and dirty rows)
        if self._pending and self.cache.encoder.has_pending_updates:
            self._resolve_pending()
        while True:
            with self.cache.lock, _stage_timer("encode"):
                eb = self._tpl_cache.encode([pi.pod for pi in pis], pad_to=pad)
                trace.step("tpl-encode")
                ptab = self._pair_table(eb)
                n_waves, batch_has_hard = self._batch_waves(eb)
                if small_bucket and not batch_has_hard:
                    # latency bucket, no hard pairs present: ≤256 pods
                    # across the cluster rarely conflict, and a deferred
                    # loser just requeues — 2 waves suffice and halve the
                    # small-cycle cost
                    n_waves = min(n_waves, 2)
                trace.step("pair-table")
                if (
                    not self._pending
                    or not self.cache.encoder.has_pending_updates
                ):
                    snap = self.cache.encoder.flush()
                    enc_cfg = self.cache.encoder.cfg
                    row_names = list(self.cache.encoder.row_names)
                    # verify_cycles: the host view the device encoding was
                    # built from — cloned under the SAME lock as the flush,
                    # or informer churn in between would read as phantom
                    # device/host mismatches
                    verify_snap = (
                        self.cache.update_snapshot()
                        if self.cfg.verify_cycles
                        else None
                    )
                    launch_gen = self.cache._ext_generation
                    break
            self._resolve_pending()
        trace.step("flush")
        # pinnedness: the pinned-row plan runs only for batches that carry
        # pinned pods (pod_name_row_np is the host copy)
        has_pinned = bool((eb.pod_name_row_np >= 0).any())
        variant = (
            enc_cfg.v_cap,
            m_cand,
            n_waves,
            self.cfg.hard_pod_affinity_weight,
            self._use_pallas_fit,
            # hard-pair batches get the per-wave refresh on EVERY device:
            # in-batch commits fill the low-count domains the batch-start
            # candidate columns chase, and a CPU hard-spread storm measured
            # bimodal convergence without it
            self._score_refresh or batch_has_hard,
            self._rtc_shape or DEFAULT_RTC_SHAPE,
            has_pinned,
        )
        kern = self._wave_kernel(variant)
        ticket = None
        if self.cfg.host_callback_binds and self._mesh is None:
            # depth-infinity micro-waves: the launch posts its own fast
            # index payload to the delivery thread under this ticket — the
            # resolve consumes the delivery instead of issuing any sync
            ticket = hostcallback.new_ticket()
            kern = _TicketedWaveKernel(
                make_wave_kernel_cb(*variant), ticket, self._hostcb.post
            )
        p_pad = int(eb.pod_tpl_np.shape[0])
        rng_key = self._noise_key(self._noise)
        noise = self._noise(p_pad, min(m_cand, enc_cfg.n_cap))
        w_launch = np.asarray(self._weights)
        t_launch0 = time.monotonic()
        try:
            new_snap, res, copies = self._launch_wave_kernel(
                kern, snap, eb.batch, ptab, w_launch, noise
            )
        except Exception:
            if ticket is not None:
                hostcallback.discard(ticket)
            with self.cache.lock:
                self.cache.encoder.invalidate_device()
            raise
        trace.step("launch")
        t_launched = time.monotonic()
        # wave-level trace: ONE record for the kernel launch the whole
        # batch shares — each pod's span chain carries `wave=<id>` so a
        # slow wave explains its N slow pods in one lookup
        wave_tid = tracer.start(
            "wave", f"wave/{len(pis)}pods", t0=t_start, pods=len(pis)
        )
        tracer.add_span(wave_tid, "encode", t_start, t_launch0)
        tracer.add_span(wave_tid, "launch", t_launch0, t_launched)
        tracer.add_span_many(
            [pi.trace_id for pi in pis], "encode", t_start, t_launched,
            wave=wave_tid,
        )
        # the donation lease inside _launch_wave_kernel already installed
        # new_snap as the live generation — nothing to publish here
        self._pending.append(
            _InFlightBatch(
                pis, eb, row_names, res, moves0, trace, t_start, verify_snap,
                launch_gen, wave_tid, t_launched, copies, ticket,
                w_launch, rng_key,
            )
        )
        metrics.inc("scheduler_wave_batches_total")
        metrics.set_gauge(GAUGE_WAVE_INFLIGHT, float(len(self._pending)))
        if len(self._pending) > self._wave_inflight_peak:
            self._wave_inflight_peak = len(self._pending)
            metrics.set_gauge(
                GAUGE_WAVE_INFLIGHT_MAX, float(self._wave_inflight_peak)
            )
        if len(self._pending) >= self._pipeline_depth:
            # pipeline full: ONE combined readback resolves every batch but
            # the newest, which stays in flight so its device time overlaps
            # the readback + the host-side bind work below
            keep = 0 if self._pipeline_depth == 1 else 1
            self._resolve_oldest(len(self._pending) - keep)
        elif self._split_phase and len(self._pending) > 1:
            # continuous micro-waves: any older wave whose fast index
            # payload ALREADY landed (async copy started at dispatch, or
            # delivered under its host-callback ticket) commits now
            # instead of waiting for the pipeline to fill — its pods stop paying the
            # pipeline-fill wait, and the device keeps computing the
            # newest wave while the host binds. Never the newest: its
            # device time is what overlaps this host work.
            n_ready = 0
            for b in self._pending[:-1]:
                if not self._fast_payload_ready(b):
                    break
                n_ready += 1
            if n_ready:
                self._resolve_oldest(n_ready)

    def _fast_payload_ready(self, b: "_InFlightBatch") -> bool:
        if b.ticket is not None and hostcallback.ready(b.ticket):
            return True
        return b.copies is not None and b.copies[0].ready()

    def _resolve_pending(self) -> None:
        self._resolve_oldest(len(self._pending))

    def _resolve_oldest(self, k: int) -> None:
        """Resolve the k oldest in-flight batches with ONE combined
        device->host readback; never raises. Placements of ALL k batches
        are replayed into the host cache (and bound) before any batch's
        failure handling runs — the fallback/preemption paths read the host
        cache, and an unreplayed sibling batch would let them grant the
        same capacity twice."""
        if k <= 0:
            return
        batches, self._pending = self._pending[:k], self._pending[k:]
        metrics.set_gauge(GAUGE_WAVE_INFLIGHT, float(len(self._pending)))
        split = self._split_phase
        t_rb0 = time.monotonic()
        with _stage_timer("kernel"):
            try:
                # transient device blips get bounded jittered retries (the
                # copies are re-readable — no donation on the read side)
                # before the loss path takes over. Split mode fetches ONLY
                # the index payload here; the bulk score trails through
                # _fetch_wave_bulk off this path.
                fetch = (
                    self._fetch_wave_index
                    if split
                    else self._fetch_wave_results
                )
                fetched = call_with_device_retry(
                    lambda: fetch(batches),
                    attempts=self.cfg.device_retry_attempts,
                    on_retry=lambda n, e: metrics.inc(
                        "scheduler_device_retries_total",
                        {"stage": "readback"},
                    ),
                )
                self._consecutive_device_loss = 0
            except Exception as e:
                for b in batches:
                    if b.ticket is not None:
                        hostcallback.discard(b.ticket)
                    tracer.finish(b.wave_tid, outcome="readback_failed")
                    for pi in b.pis:
                        tracer.event(pi.trace_id, "readback.failed")
                # device error: the kernels' on-device commits are
                # unknowable — rebuild the snapshot from the host masters
                # and retry
                with self.cache.lock:
                    self.cache.encoder.invalidate_device()
                logger.exception(
                    "wave pipeline readback failed (%d batches)", len(batches)
                )
                lost = is_device_loss_error(e)
                if lost:
                    metrics.inc(
                        "scheduler_device_loss_total", {"stage": "readback"}
                    )
                    self._handle_device_loss(e)
                moves = self.queue.moves_snapshot()
                for b in batches:
                    for pi in b.pis:
                        if self.cache.has_pod(pi.pod.metadata.key):
                            continue
                        if lost:
                            # infrastructure failure, not pod
                            # unschedulability: backoff retries in 1-10 s
                            # instead of sitting out unschedulableQ's
                            # 30-60 s leftover flush
                            self.queue.requeue_backoff(pi)
                        else:
                            self.queue.add_unschedulable_if_not_present(pi, moves)
                return
        t_rb1 = time.monotonic()
        for b in batches:
            # fan-in: the shared device wait (launch -> resolve entry) and
            # the combined readback land on the wave trace AND on every
            # pod trace riding it, in two ring acquisitions per batch
            tracer.add_span(b.wave_tid, "device", b.t_launched, t_rb0)
            tracer.add_span(b.wave_tid, "readback", t_rb0, t_rb1)
            tids = [pi.trace_id for pi in b.pis]
            tracer.add_span_many(tids, "device", b.t_launched, t_rb0)
            tracer.add_span_many(tids, "readback", t_rb0, t_rb1)
        tails = []
        quarantined = False
        for b, arrays in zip(batches, fetched):
            if quarantined:
                # an older sibling's output failed validation: this
                # batch's kernel chained on the same suspect snapshot —
                # don't act on its results, just reschedule the pods
                # (same accounting as the still-pending batches
                # _on_guard_trip pulls, or the blast-radius counters
                # undercount exactly under sustained pipelined load)
                metrics.inc(
                    "kernel_guard_trips_total",
                    {"reason": "sibling_quarantine"},
                )
                tracer.finish(b.wave_tid, outcome="sibling_quarantine")
                tails.append(None)
                for pi in b.pis:
                    tracer.event(pi.trace_id, "wave.quarantined")
                    self.queue.readd(pi)
                continue
            if split:
                # fast payload only: score arrives with the trailing bulk
                # readback — validation/decode below run with score=None
                arrays = (*arrays, None)
            try:
                tails.append(self._commit_batch(b, arrays, t_rb1))
                if b.trailing is None:
                    # combined mode — or a split batch that placed
                    # nothing: the guard story is complete right here.
                    # With a trailing entry registered, the trip counter
                    # resets only when the TRAILING validation passes
                    # (else a poisoned device alternating commit/unwind
                    # would never latch off).
                    self._consecutive_guard_trips = 0
                    tracer.finish(b.wave_tid, outcome="committed")
            except KernelGuardTrip as trip:
                quarantined = True
                tracer.finish(b.wave_tid, outcome=f"guard_trip:{trip.reason}")
                self._on_guard_trip(trip)
                # the violating batch degrades to the host path (nothing
                # was assumed for it): _finish_batch host-schedules every
                # pod — at worst the wave runs at host speed, wrong
                # placements are structurally impossible
                tails.append((list(b.pis), []))
            except Exception:
                logger.exception("committing wave batch failed")
                tracer.finish(b.wave_tid, outcome="commit_failed")
                tails.append(None)
                moves = self.queue.moves_snapshot()
                for pi in b.pis:
                    if not self.cache.has_pod(pi.pod.metadata.key):
                        self.queue.add_unschedulable_if_not_present(pi, moves)
        for b, tail in zip(batches, tails):
            if tail is None:
                continue
            try:
                self._finish_batch(b, tail[0], tail[1])
            except Exception:
                logger.exception("resolving wave batch failures failed")
                moves = self.queue.moves_snapshot()
                for pi in tail[0]:
                    if not self.cache.has_pod(pi.pod.metadata.key):
                        self.queue.add_unschedulable_if_not_present(pi, moves)
                for pi, _i in tail[1]:
                    self.queue.add_unschedulable_if_not_present(pi, moves)

    def _commit_batch(
        self, p: "_InFlightBatch", arrays, t_rb1: Optional[float] = None
    ) -> tuple:
        """Act on one read-back batch's placements: assume + bind, re-add
        deferred pods. Returns (fallback_pis, failed) for _finish_batch.
        Raises KernelGuardTrip when the batch's outputs fail validation —
        BEFORE any placement is assumed or any pod requeued.

        t_rb1: the combined readback's completion stamp — the pod traces'
        `guard` span runs from it to the assume hand-off, so waiting out
        an earlier sibling's commit is attributed, not lost in a gap."""
        pis, eb, row_names = p.pis, p.eb, p.row_names
        chosen, placed, deferred, score = arrays
        trace, t_start = p.trace, p.t_start
        trace.step("kernel")
        algo_dur = time.monotonic() - t_start
        metrics.observe("scheduling_algorithm_duration_seconds", algo_dur)
        if self.cfg.kernel_output_guards:
            # structural validation first: the decode loop below indexes
            # row_names[chosen[i]] — a wild index from a corrupted kernel
            # would either crash the commit or (negative wrap) silently
            # pick the WRONG node
            reason = validate_batch_outputs(
                chosen, placed, score, len(row_names)
            )
            if reason:
                raise KernelGuardTrip(reason)

        to_bind: List = []  # (pi, node_name, prio_band, proto)
        protos: dict = {}  # template -> shared encoder proto
        fallback_pis: List[QueuedPodInfo] = []
        failed: List = []  # (pi, tpl_index)
        deferred_pis: List[QueuedPodInfo] = []
        for i, pi in enumerate(pis):
            if eb.fallback[i]:
                fallback_pis.append(pi)
                continue
            if placed[i]:
                node_name = row_names[int(chosen[i])]
                if node_name is None:
                    failed.append((pi, i))
                    continue
                t = int(eb.pod_tpl_np[i])
                proto = protos.get(t)
                if proto is None:
                    # one spec-derived encoding per template, shared by
                    # every sibling in the batch (same fingerprint =>
                    # identical proto). Under the cache lock: the encoder's
                    # vocabs are mutated by informer threads through locked
                    # cache methods, and an intern between _match_vec and
                    # the proto's vocab-length stamp would smuggle a short
                    # match_vec past add_pod's staleness guard
                    with self.cache.lock:
                        proto = protos[t] = self.cache.encoder.pod_proto(
                            pi.pod
                        )
                to_bind.append(
                    (pi, node_name, int(eb.pod_band_np[i]), proto)
                )
            elif deferred[i]:
                deferred_pis.append(pi)
            else:
                failed.append((pi, i))
        if self.cfg.kernel_output_guards and self.cfg.guard_sample_per_wave:
            # sampled host-oracle re-check (the online analogue of
            # tests/test_fuzz_differential.py's oracle): a sample of this
            # wave's placements must pass the pre-batch-sound host filter
            # subset against the live cache. Runs BEFORE any queue/assume
            # side effect so a trip quarantines a fully-unacted batch.
            bad = self._guard_oracle_sample(to_bind, p.launch_gen)
            if bad is not None:
                raise KernelGuardTrip("oracle_infeasible", bad)
        # stall breaker: a batch that placed NOTHING but deferred pods is
        # structurally contended (e.g. a hard-spread burst whose every
        # candidate domain is serialized) — an immediate readd would hot-
        # loop the identical batch through a full wave cycle each time.
        # Route the deferred pods through BACKOFF (they are retryable, not
        # unschedulable: no condition/event, 1-10 s retry, and move events
        # re-activate backoffQ normally).
        for pi in deferred_pis:
            tracer.event(pi.trace_id, "wave.deferred")
            if to_bind:
                self.queue.readd(pi)
            else:
                self.queue.requeue_backoff(pi)
        if t_rb1 is not None:
            # guard = readback done -> assume hand-off (output validation,
            # decode, oracle sample, and any elder-sibling commit wait)
            tracer.add_span_many(
                [pi.trace_id for pi, _n, _b, _p in to_bind],
                "guard", t_rb1, time.monotonic(),
            )

        entry = None
        if self._split_phase and (
            to_bind or bool(np.asarray(placed, dtype=bool).any())
        ):
            # split-phase trailing half: the bulk score payload validates
            # off the critical path. Registered BEFORE assume so the
            # pre-bind gate below can catch an own-batch disagreement
            # while the assumes are still revertible.
            entry = p.trailing = self._register_trailing(
                p.copies[1], placed, to_bind, p.launch_gen, p.wave_tid,
            )

        if self.cfg.verify_cycles and to_bind:
            try:
                self._verify_placements(to_bind, p.snapshot)
            except Exception:
                # a diagnostic must never affect scheduling: an exception
                # here would requeue a fully successful batch while the
                # device snapshot keeps its commits
                logger.exception("verify_cycles cross-check failed")
        self._assume_and_bind_bulk(
            to_bind, t_start, device_synced=True,
            trailing_gate=(
                (lambda: self._trailing_gate(entry))
                if entry is not None
                else None
            ),
        )
        trace.step("assume+bind")
        if entry is not None and not entry.quarantined:
            entry.binds_issued = True
        if entry is None or not entry.quarantined:
            self._record_wave_for_tuner(
                p.pis,
                {id(pi): node for pi, node, _b, _pr in to_bind},
                p.weights,
                p.rng_key,
                p.launch_gen,
                path="wave",
            )
        return fallback_pis, failed

    def _record_wave_for_tuner(
        self, pis, placed_by_id, weights, rng_key, launch_gen, path
    ) -> None:
        """Feed the policy gym's replay ring (tuner/waves.py) with a
        committed batch: pod specs, the launch weight vector + noise key
        (``_noise_key``), and the placements production actually took.
        Outside every lock, one guarded append — recording must never
        perturb scheduling."""
        rec = self.wave_recorder
        if rec is None or weights is None:
            return
        try:
            pods = [pi.pod for pi in pis]
            placements = [placed_by_id.get(id(pi), "") for pi in pis]
            rec.record_wave(
                pods,
                weights,
                placements,
                rng_key=rng_key,
                launch_gen=launch_gen,
                path=path,
            )
        except Exception:
            logger.exception("wave recording failed (scheduling unaffected)")

    # Bound on full preemption scans per resolved batch: with the
    # per-(template, priority) dedup below the bound only engages when a
    # batch fails across MANY distinct templates at once; the skipped pods
    # retry preemption on their next cycle (the reference bounds work the
    # same way — one nominated node per pod per cycle,
    # pkg/scheduler/core/generic_scheduler.go:270).
    _MAX_PREEMPT_SCANS_PER_BATCH = 128

    def _finish_batch(
        self, p: "_InFlightBatch", fallback_pis: List, failed: List
    ) -> None:
        """Host fallback + failure/preemption handling for one committed
        batch (runs after EVERY sibling batch's placements are replayed).

        Storm path (soak lesson): a full cluster fails WHOLE batches of
        one template. Failure handling is deduplicated at template
        granularity — one preemption scan per (template, priority) per
        unchanged snapshot, not one per pod — and the unschedulable
        condition write is skipped when the stored condition already says
        exactly the same thing, so a 1024-pod unschedulable batch costs one
        scan + zero redundant API writes instead of 1024 scans + 2048
        writes."""
        eb, row_names, res, moves0 = p.eb, p.row_names, p.res, p.moves0
        with _stage_timer("finish"):
            if fallback_pis or failed:
                # the host paths below read the host cache; a NEWER in-flight
                # batch holds device-committed placements the cache can't see
                # yet — resolve it first or fallback/preemption would grant the
                # same capacity twice (bounded recursion: pending is detached
                # before each resolve)
                with _stage_timer("finish.resolve"):
                    self._resolve_pending()
                with _stage_timer("finish.snapshot"):
                    self._snapshot = self.cache.update_snapshot()
            if fallback_pis:
                with _stage_timer("finish.fallback"):
                    for pi in fallback_pis:
                        self._schedule_one_host(pi, moves0)
            if failed:
                with _stage_timer("finish.failed"):
                    self._finish_failed(p, failed)
        p.trace.log_if_long(0.1)

    def _finish_failed(self, p: "_InFlightBatch", failed: List) -> None:
        eb, row_names, res, moves0 = p.eb, p.row_names, p.res, p.moves0
        resolvable_tpl = res.resolvable_tpl.cpu().numpy()
        pod_tpl = eb.pod_tpl_np
        pod_prio = eb.pod_prio_np
        # vectorized victim selection (ops/preemptlattice): ONE batched
        # pass over a (template, priority)-grouped gather of the batch
        # ranks candidate nodes and minimal victim-band prefixes for
        # every failed pod; the per-pod host work below shrinks to the
        # exact oracle check on the chosen node. None (disabled / guard
        # trip / kernel error) falls back to the optimistic what-if mask
        # + the per-pod host walk.
        vec = self._vector_preempt_batch(eb, failed, pod_tpl, pod_prio)
        whatif_tpl = None
        if vec is None:
            # batched masked what-if (one device call for ALL failed
            # pods): per-template optimistic preemption mask, priority =
            # max over the batch's pods of that template so the mask
            # stays a superset for every pod
            whatif_tpl = self._preempt_whatif_tpl(eb, failed, pod_tpl)
        # (template, priority) groups whose scan on the CURRENT snapshot
        # found no viable node: siblings share the spec, so their scans
        # are provably identical — skip them. A successful preemption
        # mutates the cluster (victims deleted), which can unblock other
        # groups: clear the memo.
        hopeless: set = set()
        scans = 0
        verified = 0
        # in-batch fan-out: a wave's failed pods are overwhelmingly
        # sibling specs, and within one batch `self._snapshot` is stale —
        # victims already claimed by an earlier sibling still look
        # evictable, so without this every sibling would nominate the
        # SAME node and the batch would free exactly one node per wave
        # (measured: 89/1000 burst pods bound in 25 min). `targeted`
        # tracks nodes whose victims this batch already claimed; each
        # sibling consumes the next untargeted candidate from its group's
        # kernel ranking, so a 1k-pod burst nominates ~1k DISTINCT nodes
        # in one batched pass.
        targeted: set = set()
        group_cands: Dict[tuple, List[str]] = {}
        # the wave's resolvable masks live in the LAUNCH row space; the
        # preempt kernel ran on the post-flush one. Intersecting the two
        # is only meaningful when no churn remapped rows in between —
        # otherwise the helpful mask must not narrow the (oracle-
        # validated) fallback candidate list against the wrong nodes.
        vec_same_rows = (
            vec is not None
            and vec["row_names"][: len(row_names)] == list(row_names)
        )
        for pi, i in failed:
            t = int(pod_tpl[i])
            group = (t, int(pod_prio[i]))
            rows_mask = resolvable_tpl[t]
            vector_choice = None
            saturated = False
            if vec is not None:
                g = vec["group_of"].get(group)
                helpful = vec["helpful"]
                # vec_names is the row space the preempt kernel actually
                # ran on (captured under the lock WITH its flush) — the
                # wave-launch row_names may be stale if informer churn
                # remapped rows while the wave was in flight
                vec_names = vec["row_names"]
                if (
                    g is not None
                    and vec_same_rows
                    and helpful.shape[1] == rows_mask.shape[0]
                ):
                    rows_mask = rows_mask & helpful[g]
                if g is not None and int(vec["node"][g]) >= 0:
                    if group not in group_cands:
                        # the group's full candidate ranking: the kernel's
                        # top-K rows first, then every other helpful row
                        # in row order — the fan-out tail for groups with
                        # more siblings than K
                        ranked = [
                            int(r)
                            for r in vec["cand"][g]
                            if 0 <= int(r) < len(vec_names)
                            and vec_names[int(r)]
                        ]
                        seen = set(ranked)
                        tail = [
                            int(r)
                            for r in np.nonzero(helpful[g])[0]
                            if int(r) < len(vec_names)
                            and vec_names[int(r)]
                            and int(r) not in seen
                        ]
                        group_cands[group] = [
                            vec_names[r] for r in ranked + tail
                        ]
                    avail = [
                        n for n in group_cands[group] if n not in targeted
                    ]
                    if avail:
                        # the oracle's exact selection runs on just these
                        # (≤K) untargeted rows instead of every
                        # resolvable node
                        vector_choice = avail[: len(vec["cand"][g])]
                    else:
                        # every node this group's eviction could free is
                        # already claimed by an earlier sibling: skip this
                        # round — the pod retries next wave against a
                        # snapshot that reflects the evictions
                        saturated = True
                        metrics.inc(
                            "scheduler_preemption_fallback_total",
                            {"reason": "batch_saturated"},
                        )
            elif (
                whatif_tpl is not None
                and whatif_tpl.shape[1] == rows_mask.shape[0]
            ):
                rows_mask = rows_mask & whatif_tpl[t]
            rows = np.nonzero(rows_mask)[0]
            candidates = [
                row_names[r]
                for r in rows
                if row_names[r] and row_names[r] not in targeted
            ]
            # an attempt with a vector choice costs an exact check on ≤K
            # nodes; a full host scan runs only on fallback (no vector
            # answer) or for the sampled differential oracle below. The
            # hopeless memo covers both: siblings of a rejected group
            # would re-fail identically on the unchanged snapshot.
            attempt_would_run = bool(candidates) or vector_choice is not None
            skip = saturated or (
                attempt_would_run
                and (
                    group in hopeless
                    or scans >= self._MAX_PREEMPT_SCANS_PER_BATCH
                )
            )
            verify_full = (
                vector_choice is not None
                and not skip
                and verified < self.cfg.preempt_verify_sample
            )
            preempted = self._handle_failure(
                pi,
                moves0,
                message=f"0/{self.cache.node_count} nodes are available",
                candidate_nodes=candidates,
                skip_preemption=skip,
                vector_choice=vector_choice,
                verify_full=verify_full,
            )
            if verify_full:
                verified += 1
            if preempted:
                targeted.add(preempted)
            if attempt_would_run and not skip:
                if vector_choice is None or verify_full:
                    scans += 1  # bound the expensive full walks only
                if preempted:
                    hopeless.clear()
                else:
                    hopeless.add(group)

    # pre-batch-sound plugins: anti-monotone (or invariant) under in-batch
    # commits, so a device placement MUST pass them on the pre-batch host
    # snapshot. Inter-pod terms are excluded — batch-mates legitimately
    # CREATE affinity feasibility (carveout chains)
    _VERIFY_PLUGINS = (
        "NodeUnschedulable",
        "NodeName",
        "NodePorts",
        "NodeAffinity",
        "TaintToleration",
        "NodeResourcesFit",
    )

    def _verify_placements(self, to_bind: List, snapshot) -> None:
        """Per-cycle device-vs-host cross-check (SURVEY §5): run the host
        filter chain's pre-batch-sound subset for every placement the
        kernel committed, against the snapshot captured AT LAUNCH (the
        state the device encoding saw); a FAIL verdict means the device
        encoding and the host plugins disagree — counted and logged, never
        acted on (the live analogue of tests/test_fuzz_differential.py).
        Debug mode: the launch-time snapshot clone is the cost."""
        if snapshot is None:
            return
        for pi, node_name, _band, _proto in to_bind:
            ni = snapshot.node_info_map.get(node_name)
            if ni is None:
                continue
            fail = self._check_placement(pi, ni)
            if fail is not None:
                name, st = fail
                metrics.inc(
                    "scheduler_verify_mismatch_total", {"plugin": name}
                )
                logger.error(
                    "verify_cycles: device placed %s on %s but host "
                    "plugin %s says %s",
                    pi.pod.metadata.key,
                    node_name,
                    name,
                    st.message or st.code,
                )

    def _check_placement(self, pi, ni):
        """Run the pre-batch-sound host filter subset (_VERIFY_PLUGINS)
        for one kernel placement. Returns (plugin_name, status) on the
        first failure, else None. Shared by the diagnostic cross-check
        (_verify_placements) and the acting oracle guard."""
        prof = self.profiles.for_pod(pi.pod)
        if prof is None:
            return None
        fw = prof.framework
        state = CycleState()
        for name in self._VERIFY_PLUGINS:
            if not fw.has_filter_plugin(name):
                continue
            st = fw.plugin(name).filter(state, pi.pod, ni)
            if not is_success(st):
                return name, st
        return None

    def _guard_oracle_sample(
        self, to_bind: List, launch_gen: int
    ) -> Optional[str]:
        """Re-check a deterministic sample of this wave's placements
        against the host filter chain's pre-batch-sound subset
        (_VERIFY_PLUGINS), on the LIVE cache NodeInfos under the cache
        lock. By the time a batch commits, every older batch's placements
        have been replayed into the cache, so the cache equals the state
        this batch's kernel encoding saw — EXCEPT for mutations no device
        chain saw: nodes the informer touched after launch (cordon,
        taint, external bind) AND host-path assumes (fallback pods
        scheduled between this batch's launch and commit). Both stamp
        ext_generation past `launch_gen` and are skipped, because a
        placement that was sound at encode time failing against NEWER
        node state is churn, not kernel corruption — acting on it would
        quarantine a correct batch.
        Sibling-batch DEVICE assumes deliberately do NOT move
        ext_generation: the device chain saw those placements, so a
        disagreement there is a real kernel signal.
        Returns a human-readable detail string on violation, else None."""
        k = min(self.cfg.guard_sample_per_wave, len(to_bind))
        if k <= 0:
            return None
        step = max(1, len(to_bind) // k)
        sample = to_bind[::step][:k]
        with self.cache.lock:
            for pi, node_name, _band, _proto in sample:
                ni = self.cache._nodes.get(node_name)
                if ni is None:
                    # node vanished mid-flight (informer remove): the
                    # assume path parks this as an orphan — not a kernel
                    # correctness signal
                    continue
                if ni.ext_generation > launch_gen:
                    metrics.inc(
                        "kernel_guard_oracle_skips_total",
                        {"reason": "node_churn"},
                    )
                    continue
                fail = self._check_placement(pi, ni)
                if fail is not None:
                    name, st = fail
                    return (
                        f"{pi.pod.metadata.key} on {node_name}: "
                        f"{name} says {st.message or st.code}"
                    )
        return None

    def _on_guard_trip(self, trip: KernelGuardTrip) -> None:
        """A batch's outputs failed validation: count it, force a device
        snapshot rebuild (its commits are suspect), and pull every NEWER
        in-flight batch out of the pipeline unread — their kernels
        chained on the same suspect snapshot. Their pods requeue
        un-assumed (zero loss); repeated trips latch the device down."""
        metrics.inc("kernel_guard_trips_total", {"reason": trip.reason})
        logger.error(
            "kernel output guard tripped (%s): batch quarantined to the "
            "host path, snapshot rebuild forced", trip
        )
        with self.cache.lock:
            self.cache.encoder.invalidate_device()
        pending, self._pending = self._pending, []
        for b in pending:
            metrics.inc(
                "kernel_guard_trips_total", {"reason": "sibling_quarantine"}
            )
            if b.ticket is not None:
                hostcallback.discard(b.ticket)
            tracer.finish(b.wave_tid, outcome="sibling_quarantine")
            for pi in b.pis:
                tracer.event(pi.trace_id, "wave.quarantined")
                self.queue.readd(pi)
        self._consecutive_guard_trips += 1
        if self._consecutive_guard_trips >= self.cfg.device_loss_disable_after:
            logger.error(
                "%d consecutive kernel guard trips: abandoning the device "
                "path for the host path", self._consecutive_guard_trips,
            )
            self._set_device_down()

    def _set_device_down(self) -> None:
        self._device_down = True
        metrics.set_gauge("scheduler_device_down", 1.0)

    def _handle_device_loss(self, exc: BaseException) -> None:
        """Unrecoverable-by-retry device loss. Escalation ladder: shrink
        the mesh to the surviving devices (re-shard the snapshot, drop the
        kernel caches keyed on the dead mesh), ride out a fully-transient
        blip with just the forced re-upload, or — nothing usable, or
        losses keep repeating — latch the device path off and serve from
        the host path."""
        self._consecutive_device_loss += 1
        metrics.set_gauge(
            "scheduler_device_consecutive_loss",
            float(self._consecutive_device_loss),
        )
        if self._consecutive_device_loss >= self.cfg.device_loss_disable_after:
            logger.error(
                "%d consecutive device-loss events without a successful "
                "launch: abandoning the device path",
                self._consecutive_device_loss,
            )
            self._set_device_down()
            return
        if self._mesh is not None:
            from ..parallel import sharded
            from ..parallel.mesh import (
                largest_pow2_prefix,
                make_mesh,
                replicated,
                single_device_shardings,
                snapshot_shardings,
                surviving_devices,
            )

            devices = list(self._mesh.devices)
            survivors = surviving_devices(devices, probe=self._device_probe)
            usable = largest_pow2_prefix(survivors)
            if len(survivors) == len(devices):
                # every device answers: a transient transfer failure — the
                # invalidate already queued a full re-upload
                logger.warning(
                    "device loss looks transient (%d/%d devices respond): "
                    "keeping the mesh, snapshot re-uploads",
                    len(survivors), len(devices),
                )
                return
            if usable:
                # the kernel caches hold kernels built for the DEAD mesh:
                # clear them before any launch against the new one
                sharded.make_sharded_wave_kernel.cache_clear()
                sharded.make_sharded_schedule_batch.cache_clear()
                new_mesh = make_mesh(usable) if len(usable) > 1 else None
                with self.cache.lock:
                    if new_mesh is not None:
                        self.cache.encoder.set_sharding(
                            snapshot_shardings(new_mesh),
                            replicated(new_mesh),
                        )
                    else:
                        # one survivor: pin uploads to IT — an unpinned
                        # encoder uploads to its own device, which may be
                        # the dead one
                        self.cache.encoder.set_sharding(
                            *single_device_shardings(usable[0])
                        )
                self._mesh = new_mesh
                self._pair_cache = None
                self._follow_encoder_device()
                metrics.inc("scheduler_mesh_shrinks_total")
                metrics.set_gauge(
                    "scheduler_mesh_devices", float(max(len(usable), 1))
                )
                logger.error(
                    "mesh shrunk to %d surviving device(s) after device "
                    "loss (%s); snapshot re-sharded", len(usable), exc,
                )
                return
            logger.error(
                "no surviving devices after device loss (%s): host path", exc
            )
            self._set_device_down()
            return
        # single-device: probe it once — if even a trivial round-trip
        # fails the device is gone
        try:
            if self._device_probe(self.device):
                logger.warning(
                    "device loss looks transient (probe ok): snapshot "
                    "re-uploads on the next flush"
                )
                return
        except Exception:
            pass
        self._set_device_down()

    @staticmethod
    def _device_probe(device) -> bool:
        """One tiny put/get round-trip (injectable via monkeypatching for
        chaos tests, which may declare mesh entries dead by their id;
        device=None probes the current CUDA device)."""
        from ..parallel.mesh import _default_probe

        return _default_probe(device)

    # pad buckets for the (template, priority)-grouped preemption batch:
    # failed-group counts are small (distinct specs x priority tiers, not
    # pods); two buckets keep the pass's shapes few
    _PREEMPT_PAD_BUCKETS = (16, 128)

    def _run_preempt_kernel(self, snap, batch, prios: np.ndarray) -> dict:
        """Launch + readback of the vectorized victim-selection kernel —
        one synchronous call, split out as an injectable seam for the
        differential tests' seeded-disagreement corruption (mirrors
        _run_serial_kernel)."""
        res = preempt_select(
            gather_snapshot(snap), batch,
            torch.as_tensor(np.asarray(prios, np.int32), device=self.device),
        )
        return {
            "node": res.node.cpu().numpy(),
            "cand": res.cand.cpu().numpy(),
            "threshold": res.threshold_prio.cpu().numpy(),
            "victims": res.victims.cpu().numpy(),
            "violations": res.violations.cpu().numpy(),
            "helpful": res.helpful.cpu().numpy(),
        }

    def _vector_preempt_batch(
        self, eb, failed: List, pod_tpl: np.ndarray, pod_prio: np.ndarray
    ) -> Optional[dict]:
        """ONE batched victim-selection pass for a resolved wave's failed
        pods (ops/preemptlattice.preempt_select): failed pods group by
        (template, priority) — siblings share the whole answer — the
        template tensors gather into a [G]-row PodBatch, and the kernel
        ranks (node, minimal victim-band prefix) per group against a
        freshly-flushed snapshot whose PDB budget column was just
        refreshed from the disruption controller's published budgets.
        Readback passes through validate_preempt_outputs (the kernel-
        output guard discipline) — a trip, a kernel error, or the config
        gate returns None and the caller falls back to the host walk;
        nothing is ever evicted from this result without the per-node
        host-oracle check in _attempt_preemption."""
        if (
            not self.cfg.vector_preemption
            or self.cfg.disable_preemption
            or self._device_down
            or not self.cfg.use_device
        ):
            return None
        try:
            groups: Dict[tuple, int] = {}
            t_idx: List[int] = []
            g_prio: List[int] = []
            for pi, i in failed:
                if i < 0:
                    continue  # decode anomaly: host walk handles it
                key = (int(pod_tpl[i]), int(pod_prio[i]))
                if key not in groups:
                    groups[key] = len(t_idx)
                    t_idx.append(key[0])
                    g_prio.append(key[1])
            if not groups:
                return None
            pad = self._PREEMPT_PAD_BUCKETS[-1]
            for b in self._PREEMPT_PAD_BUCKETS:
                if len(t_idx) <= b:
                    pad = b
                    break
            if len(t_idx) > pad:
                # more distinct groups than the widest bucket: the tail
                # falls back to the host walk (counted, never silent)
                metrics.inc(
                    "scheduler_preemption_fallback_total",
                    {"reason": "group_overflow"},
                )
                t_idx, g_prio = t_idx[:pad], g_prio[:pad]
                groups = {k: g for k, g in groups.items() if g < pad}
            idx = np.zeros(pad, np.int64)
            idx[: len(t_idx)] = t_idx
            prios = np.zeros(pad, np.int32)
            prios[: len(g_prio)] = g_prio
            # the PDB list can be a store round-trip (REST-backed server):
            # never hold the cache lock across it
            pdbs = list(self._list_pdbs()) if self._list_pdbs else []
            with self.cache.lock:
                # _finish_batch drains the pipeline before failure
                # handling, so no newer batch's un-replayed device commits
                # can be erased by this flush
                assert not self._pending
                self.cache.encoder.update_pdb_blocked(pdbs)
                snap = self.cache.encoder.flush()
                # decode rows against the SAME row space the kernel ran
                # on: informer churn during the in-flight wave can remap
                # encoder rows, so the wave-launch row_names must never
                # decode this pass's output
                vec_row_names = list(self.cache.encoder.row_names)
                n_rows = len(vec_row_names)
            tpl = eb.batch.tpl
            rows = torch.as_tensor(idx, device=tpl.valid.device)
            gathered = PodBatch(*(f.index_select(0, rows) for f in tpl))
            gathered = gathered._replace(
                valid=gathered.valid
                & (torch.arange(pad, device=rows.device) < len(t_idx))
            )
            t0 = time.monotonic()
            vec = self._run_preempt_kernel(snap, gathered, prios)
            dt = time.monotonic() - t0
            metrics.inc("scheduler_preemption_batches_total")
            metrics.observe("scheduler_preemption_select_duration_seconds", dt)
            metrics.set_gauge(
                "scheduler_preemption_last_select_ms", round(dt * 1e3, 3)
            )
            reason = validate_preempt_outputs(
                vec["node"], vec["victims"], n_rows, cand=vec["cand"]
            )
            if reason:
                metrics.inc(
                    "scheduler_preemption_guard_trips_total",
                    {"reason": reason},
                )
                logger.error(
                    "preemption kernel output guard tripped (%s): victim "
                    "selection for this batch degrades to the host walk",
                    reason,
                )
                return None
            vec["group_of"] = groups
            vec["row_names"] = vec_row_names
            return vec
        except Exception:
            logger.exception(
                "vectorized victim selection failed; host walk"
            )
            metrics.inc(
                "scheduler_preemption_fallback_total",
                {"reason": "kernel_error"},
            )
            return None

    def _preempt_whatif_tpl(self, eb, failed: List, pod_tpl: np.ndarray):
        """[TPL, N] optimistic preemption mask for the batch's templates
        (ops/lattice.preempt_whatif), or None when unavailable."""
        try:
            prios = np.zeros(eb.tpl_np.valid.shape[0], np.int32)
            pod_prio = eb.pod_prio_np
            for pi, i in failed:
                t = int(pod_tpl[i])
                prios[t] = max(prios[t], int(pod_prio[i]))
            with self.cache.lock:
                # _finish_batch drains the pipeline before the failed
                # block, so no newer batch can be in flight here and flush's
                # scatter cannot erase un-replayed device commits
                assert not self._pending
                snap = self.cache.encoder.flush()
            snap = gather_snapshot(snap)
            mask = preempt_whatif(
                snap, eb.batch.tpl,
                torch.as_tensor(prios, device=snap.valid.device),
            )
            return mask.cpu().numpy()
        except Exception:
            logger.exception("preempt what-if kernel failed; using resolvable only")
            return None

    def _assume_and_bind_bulk(
        self, to_bind: List, t_start: float, device_synced: bool = False,
        trailing_gate=None,
    ) -> None:
        """Assume + bind a whole wave of placements ((pi, node, band,
        proto) tuples; proto may be None for host-path placements). When
        the profile has no permit/prebind/postbind plugins and the binder
        is the default, the binds collapse into one batch API call (the
        in-cycle fast path — async per-pod binding remains for
        plugin-bearing profiles, matching the reference's
        goroutine-per-bind at scheduler.go:666)."""
        if not to_bind:
            return
        t_a0 = time.monotonic()
        # ONE lock acquisition + vectorized encoder scatters for the whole
        # wave (device_synced path); the host fallback path still assumes
        # per pod through the same cache method semantics
        if device_synced:
            errors = self.cache.assume_pods_bulk(
                [(pi.pod, node_name, band, proto)
                 for pi, node_name, band, proto in to_bind]
            )
        else:
            errors = []
            for pi, node_name, band, proto in to_bind:
                try:
                    self.cache.assume_pod(
                        pi.pod,
                        node_name,
                        device_synced=False,
                        prio_band=band,
                        proto=proto,
                    )
                    errors.append(None)
                except ValueError as e:
                    errors.append(str(e))
        tracer.add_span_many(
            [pi.trace_id
             for (pi, _n, _b, _p), err in zip(to_bind, errors)
             if err is None],
            "assume", t_a0, time.monotonic(),
        )
        if trailing_gate is not None and trailing_gate():
            # split-phase last-look: between assume and bind the trailing
            # bulk payload (ours or an elder sibling's on the same
            # snapshot chain) arrived and failed validation. The binds
            # have NOT left the process — revert every assume and requeue
            # instead of issuing bindings off a condemned fast payload.
            for (pi, _node, _band, _proto), err in zip(to_bind, errors):
                if err is not None:
                    self._handle_failure(
                        pi, self.queue.moves_snapshot(),
                        message=err, error=True,
                    )
                    continue
                try:
                    self.cache.forget_pod(pi.pod)
                except Exception:
                    logger.exception("trailing gate unwind forget failed")
                metrics.inc(COUNTER_WAVE_TRAILING_UNWOUND)
                tracer.event(pi.trace_id, "wave.trailing_unwound")
                self.queue.requeue_backoff(pi)
            return
        simple: List = []
        for (pi, node_name, band, proto), err in zip(to_bind, errors):
            pod = pi.pod
            if err is not None:
                if device_synced:
                    # the kernel already committed this placement on-device;
                    # with no host replay the row must be re-uploaded
                    with self.cache.lock:
                        self.cache.encoder.mark_row_dirty(node_name)
                self._handle_failure(
                    pi, self.queue.moves_snapshot(), message=err, error=True
                )
                continue
            prof = self.profiles.for_pod(pod)
            ps = prof.framework.plugin_set
            plain = (
                self.cfg.sync_batch_bind
                and not ps.reserve
                and not ps.permit
                and not ps.pre_bind
                and not ps.post_bind
                and ps.bind == ["DefaultBinder"]
            )
            self.queue.delete_nominated_if_exists(pod)
            if plain:
                simple.append((pi, node_name, prof))
            else:
                self._assume_and_bind_after_assume(pi, node_name, t_start)
        if not simple:
            return
        bindings = [
            Binding(
                pod_name=pi.pod.metadata.name,
                pod_namespace=pi.pod.metadata.namespace,
                pod_uid=pi.pod.metadata.uid,
                target_node=node_name,
            )
            for pi, node_name, _ in simple
        ]
        b0 = time.monotonic()
        try:
            errors = self._bind_pods_fenced(bindings)
        except DegradedWrites as e:
            # in-process store: the gate refused before applying anything
            # (Degraded — safe to replay) or the whole batch applied but
            # missed its quorum ack (QuorumLost — outcome unknown). Either
            # way the wave is NOT failed: park every placement.
            errors = [e] * len(bindings)
        except LeaderFenced:
            # zombie ex-leader: the store holds a newer leadership grant.
            # Nothing applied — drop every placement and stand down.
            self._on_fenced_binds([pi for pi, _n, _p in simple])
            return
        t_b1 = time.monotonic()
        bind_dur = t_b1 - b0
        e2e = t_b1 - t_start
        tracer.add_span_many(
            [pi.trace_id
             for (pi, _n, _p), err in zip(simple, errors)
             if err is None],
            "bind", b0, t_b1,
        )
        to_buffer: List[PendingBind] = []
        for (pi, node_name, prof), err in zip(simple, errors):
            if err is None:
                metrics.observe("binding_duration_seconds", bind_dur)
                # exemplar: the tail samples carry the trace id, so the
                # histogram's p99 resolves to this pod's full waterfall
                metrics.observe(
                    "e2e_scheduling_duration_seconds", e2e,
                    exemplar=pi.trace_id or None,
                )
                # queue-entry → bound, incl. queue wait (reference
                # pod_scheduling_duration_seconds, metrics.go:51-231) — the
                # honest per-pod number the latency bench reports
                self._record_bound(pi, node_name, prof)
            elif isinstance(err, DegradedWrites):
                # retryable store refusal (incl. QuorumLost, where THIS
                # bind applied but wasn't acked — the reconciler's
                # read-back discriminates): the pod stays assumed — its
                # assume TTL is unarmed, so the reservation holds for
                # the whole outage
                to_buffer.append(PendingBind(pi, node_name, prof))
            else:
                self.cache.forget_pod(pi.pod)
                self._handle_failure(
                    pi, self.queue.moves_snapshot(), message=str(err), error=True
                )
        if to_buffer:
            self._buffer_pending_binds(to_buffer)

    def _assume_and_bind_after_assume(
        self, pi: QueuedPodInfo, node_name: str, t_start: float
    ) -> None:
        """Plugin-bearing profile: run reserve/permit then async bind (the
        pod is already assumed)."""
        t_a0 = time.monotonic()
        pod = pi.pod
        prof = self.profiles.for_pod(pod)
        fw = prof.framework
        state = CycleState()
        st = fw.run_reserve_plugins(state, pod, node_name)
        if not is_success(st):
            self.cache.forget_pod(pod)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=st.message, error=True)
            return
        st = fw.run_permit_plugins(state, pod, node_name)
        if st is not None and st.code not in (Code.SUCCESS, Code.WAIT):
            self.cache.forget_pod(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=st.message)
            return
        self._stamp_bind_submit(pi, t_a0)
        try:
            self._bind_pool.submit(
                self._bind_async, pi, node_name, state, t_start
            )
        except RuntimeError:
            # pool shut down mid-cycle (stop racing a final batch): unwind
            # like a failed bind so the reservation doesn't leak
            self.cache.forget_pod(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(
                pi, self.queue.moves_snapshot(), message="scheduler shutting down"
            )

    # -- host fallback path ---------------------------------------------------

    def _schedule_one_host(self, pi: QueuedPodInfo, moves0: int) -> None:
        t0 = time.monotonic()
        pod = pi.pod
        prof = self.profiles.for_pod(pod)
        algo = self._algo[prof.name]
        # fresh snapshot per cycle so earlier assumes in this batch are seen
        # (scheduleOne snapshots per pod, generic_scheduler.go:142)
        self._snapshot = self.cache.update_snapshot()
        state = CycleState()
        try:
            result = algo.schedule(
                pod, self._snapshot, state, self._nominated_pods_for_node
            )
        except FitError as fe:
            metrics.observe("scheduling_algorithm_duration_seconds", time.monotonic() - t0)
            self._handle_failure(pi, moves0, message=str(fe), fit_error=fe)
            return
        except Exception as e:
            # cycle error (e.g. required extender unreachable): backoff and
            # retry without attempting preemption
            metrics.observe("scheduling_algorithm_duration_seconds", time.monotonic() - t0)
            self._handle_failure(pi, moves0, message=str(e), error=True)
            return
        metrics.observe("scheduling_algorithm_duration_seconds", time.monotonic() - t0)
        # the span starts at cycle ENTRY (t0), not at algo.schedule: the
        # per-cycle snapshot clone is real latency and must be attributed
        tracer.add_span(pi.trace_id, "algo", t0, time.monotonic())
        self._assume_and_bind(pi, result.suggested_host, t0)

    def _nominated_pods_for_node(self, node_name: str) -> List[v1.Pod]:
        keys = self.queue.nominated_pods_for_node(node_name)
        out = []
        pods_informer = self.informer_factory.informer("pods")
        for k in keys:
            p = pods_informer.get(k)
            if p is not None:
                out.append(p)
        return out

    # -- assume + bind --------------------------------------------------------

    def _pod_has_pvcs(self, pod: v1.Pod) -> bool:
        return any(vol.persistent_volume_claim for vol in pod.spec.volumes)

    def _assume_volumes(self, pi: QueuedPodInfo, node_name: str) -> bool:
        """VolumeBinder.AssumePodVolumes before Reserve (scheduler.go:615).
        Returns False (after recording the failure) when no volume plan
        exists for the chosen node."""
        pod = pi.pod
        if not self._pod_has_pvcs(pod):
            return True
        if self._snapshot is None:
            self._snapshot = self.cache.update_snapshot()
        ni = self._snapshot.get(node_name)
        if ni is None:
            return True
        try:
            self.volume_binder.assume_pod_volumes(pod, ni.node)
        except Exception as e:
            self._handle_failure(pi, self.queue.moves_snapshot(), message=str(e), error=True)
            return False
        return True

    def _stamp_bind_submit(self, pi: QueuedPodInfo, t_a0: float) -> None:
        """Close the per-pod `assume` span (reserve/assume/permit work on
        the scheduling thread) and stamp the bind-pool hand-off moment:
        _bind_async starts its `bind` span there, so pool queue wait is
        attributed to `bind` instead of vanishing into a span hole."""
        now = time.monotonic()
        tracer.add_span(pi.trace_id, "assume", t_a0, now)
        pi._bind_submitted_at = now

    def _assume_and_bind(self, pi: QueuedPodInfo, node_name: str, t_start: float) -> None:
        t_a0 = time.monotonic()
        pod = pi.pod
        prof = self.profiles.for_pod(pod)
        fw = prof.framework
        state = CycleState()
        if not self._assume_volumes(pi, node_name):
            return
        st = fw.run_reserve_plugins(state, pod, node_name)
        if not is_success(st):
            self.volume_binder.forget_pod_volumes(pod)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=st.message, error=True)
            return
        try:
            self.cache.assume_pod(pod, node_name)
        except ValueError as e:
            self.volume_binder.forget_pod_volumes(pod)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=str(e), error=True)
            return
        self.queue.delete_nominated_if_exists(pod)
        st = fw.run_permit_plugins(state, pod, node_name)
        if st is not None and st.code not in (Code.SUCCESS, Code.WAIT):
            self.cache.forget_pod(pod)
            self.volume_binder.forget_pod_volumes(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=st.message)
            return
        self._stamp_bind_submit(pi, t_a0)
        try:
            self._bind_pool.submit(
                self._bind_async, pi, node_name, state, t_start
            )
        except RuntimeError:
            # pool shut down mid-cycle (stop racing a final batch): unwind
            # like a failed bind so the reservation doesn't leak
            self.cache.forget_pod(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(
                pi, self.queue.moves_snapshot(), message="scheduler shutting down"
            )

    def _bind_async(self, pi: QueuedPodInfo, node_name: str, state, t_start) -> None:
        """binding cycle (async goroutine at scheduler.go:666)."""
        pod = pi.pod
        prof = self.profiles.for_pod(pod)
        fw = prof.framework
        b0 = time.monotonic()
        # span start: the hand-off stamp (pool queue wait belongs to the
        # bind stage); the binding_duration metric keeps b0 semantics
        t_span0 = getattr(pi, "_bind_submitted_at", None) or b0
        try:
            st = fw.wait_on_permit(pod)
            if not is_success(st):
                raise RuntimeError(f"permit: {st.message}")
            # bindVolumes before PreBind (scheduler.go:454,704)
            if self._pod_has_pvcs(pod):
                self.volume_binder.bind_pod_volumes(pod, node_name)
            st = fw.run_pre_bind_plugins(state, pod, node_name)
            if not is_success(st):
                raise RuntimeError(f"prebind: {st.message}")
            # extendersBinding (scheduler.go:496,517): first interested
            # binder extender wins; else in-tree bind plugins
            ext_binder = next(
                (
                    e
                    for e in self.extenders
                    if e.is_binder() and e.is_interested(pod)
                ),
                None,
            )
            if ext_binder is not None:
                # an extender binds out of process — the store can't
                # validate the fence atomically, so pre-check the lease
                # right before handing the pod over (best-effort: the
                # in-tree paths stay store-fenced)
                self._check_fence_live()
                ext_binder.bind(pod, node_name)
            else:
                # DefaultBinder binds through the _FencedBindSurface in
                # the framework context: the write funnels into
                # _bind_pods_fenced and carries the leadership fence
                st = fw.run_bind_plugins(state, pod, node_name)
                if not is_success(st):
                    raise RuntimeError(f"bind: {st.message}")
            self.cache.finish_binding(pod)
            fw.run_post_bind_plugins(state, pod, node_name)
            t_done = time.monotonic()
            tracer.add_span(pi.trace_id, "bind", t_span0, t_done)
            metrics.observe("binding_duration_seconds", t_done - b0)
            metrics.observe(
                "e2e_scheduling_duration_seconds", t_done - t_start,
                exemplar=pi.trace_id or None,
            )
            metrics.observe(
                "pod_scheduling_duration_seconds",
                t_done - pi.initial_attempt_timestamp,
                exemplar=pi.trace_id or None,
            )
            metrics.inc("schedule_attempts_total", {"result": "scheduled"})
            tracer.finish(pi.trace_id, outcome="bound", node=node_name)
            prof.recorder.eventf(
                pod, "Normal", "Scheduled", "Binding",
                f"Successfully assigned {pod.metadata.key} to {node_name}",
            )
        except LeaderFenced:
            # deposed mid-async-bind: the new leader owns this pod now.
            # Unreserve and drop the placement — never requeue or retry
            # (racing the new leader is exactly what the fence forbids).
            self.volume_binder.forget_pod_volumes(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._on_fenced_binds([pi])
        except DegradedWrites as e:
            if not self._pod_has_pvcs(pod):
                # retryable store refusal mid-async-bind: park the
                # placement (the pod stays assumed/reserved) instead of
                # failing it — the reconciler finishes or unwinds it when
                # writes reopen. PVC pods fall through to the generic
                # unwind: their volume-bind writes may be half-applied
                # and need a full fresh cycle.
                self._buffer_pending_binds([PendingBind(pi, node_name, prof)])
                return
            self.cache.forget_pod(pod)
            self.volume_binder.forget_pod_volumes(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=str(e), error=True)
        except Exception as e:
            self.cache.forget_pod(pod)
            self.volume_binder.forget_pod_volumes(pod)
            fw.run_unreserve_plugins(state, pod, node_name)
            self._handle_failure(pi, self.queue.moves_snapshot(), message=str(e), error=True)

    # -- failure path ---------------------------------------------------------

    def _handle_failure(
        self,
        pi: QueuedPodInfo,
        moves0: int,
        message: str = "",
        fit_error: Optional[FitError] = None,
        candidate_nodes: Optional[List[str]] = None,
        error: bool = False,
        skip_preemption: bool = False,
        vector_choice: Optional[List[str]] = None,
        verify_full: bool = False,
    ) -> str:
        """Returns the nominated node name when a preemption was
        performed (cluster mutated), else '' — callers that only care
        whether the cluster changed use it as a bool; _finish_batch's
        fan-out also needs WHICH node to mark targeted."""
        pod = pi.pod
        prof = self.profiles.for_pod(pod)
        tracer.event(
            pi.trace_id, "error" if error else "unschedulable", message
        )
        metrics.inc(
            "schedule_attempts_total",
            {"result": "error" if error else "unschedulable"},
        )
        prof.recorder.eventf(
            pod, "Warning", "FailedScheduling", "Scheduling", message
        )
        # permit plugins may hold siblings of this pod parked (gang quorum);
        # tell them the member failed so reservations release promptly
        for name in prof.framework.plugin_set.permit:
            hook = getattr(
                prof.framework.plugin(name), "handle_scheduling_failure", None
            )
            if hook is not None:
                try:
                    hook(pod)
                except Exception:
                    logger.exception("permit failure hook %s", name)
        self._set_pod_unschedulable_condition(pod, message)
        preempted = ""
        if not error and not self.cfg.disable_preemption and not skip_preemption:
            try:
                preempted = self._attempt_preemption(
                    pod, prof, fit_error, candidate_nodes,
                    vector_choice=vector_choice,
                    verify_full=verify_full,
                )
            except (DegradedWrites, NotPrimary):
                # degraded store: victim deletes / nominations can't land;
                # the pod requeues and preemption retries after recovery —
                # the skip stamps the pod's OWN trace id so a preemption-
                # delayed pod's waterfall shows where the time went
                tracer.event(pi.trace_id, "preempt.degraded_skip")
                metrics.inc(
                    "scheduler_degraded_write_skips_total",
                    {"write": "preemption"},
                )
        self.queue.add_unschedulable_if_not_present(pi, moves0)
        return preempted

    def _set_pod_unschedulable_condition(self, pod: v1.Pod, message: str) -> None:
        def mutate(p):
            for c in p.status.conditions:
                if c.type == v1.COND_POD_SCHEDULED:
                    if (
                        c.status == "False"
                        and c.reason == "Unschedulable"
                        and c.message == message
                    ):
                        # no-op write suppression (the reference's
                        # podutil.UpdatePodCondition returns false on an
                        # identical condition and the caller skips the
                        # PATCH): in an unschedulable storm every re-failed
                        # pod would otherwise rewrite the same condition —
                        # an API write + watch fan-out per pod per cycle
                        return None
                    c.status = "False"
                    c.reason = "Unschedulable"
                    c.message = message
                    return p
            p.status.conditions.append(
                v1.PodCondition(
                    type=v1.COND_POD_SCHEDULED,
                    status="False",
                    reason="Unschedulable",
                    message=message,
                )
            )
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except (DegradedWrites, NotPrimary):
            # best-effort status write: while the store is read-only the
            # condition is skipped, not retried — failing the failure
            # handler here would turn one outage into a requeue storm
            metrics.inc(
                "scheduler_degraded_write_skips_total", {"write": "condition"}
            )

    def _preempt_choice_cooptimal(
        self, victims: List, ovictims: List
    ) -> bool:
        """Documented tie-break check for the sampled differential
        oracle: the vector engine's choice counts as AGREEING with the
        full host walk when the two exact victim sets tie on
        pickOneNodeForPreemption criteria 1-4 (PDB violations, max
        victim priority, priority sum, victim count) — the engine breaks
        such ties by row order where the oracle uses start time / name
        order, and the band-prefix ranking may legitimately land on a
        co-optimal node. Anything beyond that is a real divergence."""
        from .preemption import filter_pods_with_pdb_violation

        pdbs = list(self._list_pdbs()) if self._list_pdbs else []

        def key(vs):
            violating, _ = filter_pods_with_pdb_violation(list(vs), pdbs)
            return (
                len(violating),
                max((v.priority for v in vs), default=-(2 ** 31)),
                sum(v.priority for v in vs),
                len(vs),
            )

        return key(victims) == key(ovictims)

    def _attempt_preemption(
        self,
        pod,
        prof,
        fit_error,
        candidate_nodes: Optional[List[str]],
        vector_choice: Optional[List[str]] = None,
        verify_full: bool = False,
    ) -> str:
        """sched.preempt (scheduler.go:392): find victims, delete them, set
        NominatedNodeName. Returns the nominated node ('' if none).

        vector_choice = the batched kernel pass's ranked candidate node
        names (ops/preemptlattice top-K): the host oracle then runs its
        EXACT selection (filters + reprieve + PDB countdown + the full
        5-criterion node pick) on those K nodes instead of walking every
        candidate — a fully-rejected candidate set is a counted
        disagreement that falls back to the full walk, so a kernel
        ranking error costs time, never a wrong eviction. verify_full
        additionally runs the full walk and compares (the sampled
        differential oracle); on divergence beyond the documented
        tie-breaks the oracle's answer wins."""
        if self._snapshot is None:
            self._snapshot = self.cache.update_snapshot()
        preemptor = self._preemptors[prof.name]
        tid = tracer.trace_for_pod(pod.metadata.key)
        node, victims = "", []
        with tracer.span(tid, "preempt.select"):
            if vector_choice is not None:
                node, victims = preemptor.preempt(
                    pod, self._snapshot, fit_error, vector_choice
                )
                if node:
                    metrics.inc("scheduler_preemption_vector_hits_total")
                else:
                    # the exact oracle rejected the kernel's ranked
                    # winner (reprieve/PDB refinement, or a seeded
                    # disagreement in tests): host walk, zero evictions
                    # from the rejected proposal
                    metrics.inc(
                        "scheduler_preemption_fallback_total",
                        {"reason": "oracle_reject"},
                    )
            if verify_full or not node:
                # candidate_nodes semantics: None = unknown (scan per
                # fit_error / all nodes); a list — possibly empty — is the
                # device pass's narrowed candidate set and is
                # authoritative (empty = hopeless). The VERIFY walk (node
                # already accepted) must see the same universe the engine
                # drew from — candidate_nodes was intersected with the
                # wave-launch resolvable mask, so a node the wave's own
                # binds just filled can be in vector_choice but not
                # candidates; comparing across different universes would
                # count a legitimate pick as a divergence and discard it
                verify_nodes = candidate_nodes
                if node and candidate_nodes is not None:
                    verify_nodes = sorted(
                        set(candidate_nodes) | set(vector_choice or [])
                    )
                onode, ovictims = preemptor.preempt(
                    pod, self._snapshot, fit_error, verify_nodes
                )
                if not node:
                    node, victims = onode, ovictims
                elif onode != node or (
                    {v.metadata.key for v in ovictims}
                    != {v.metadata.key for v in victims}
                ):
                    if not onode or not self._preempt_choice_cooptimal(
                        victims, ovictims
                    ):
                        metrics.inc(
                            "scheduler_preemption_oracle_divergence_total"
                        )
                        logger.warning(
                            "vector preemption diverged from the host "
                            "oracle for %s (vector %s, oracle %s): using "
                            "the oracle's answer",
                            pod.metadata.key, node, onode or "<none>",
                        )
                        node, victims = onode, ovictims
        if not node:
            return ""
        # zombie-fence pre-check (the _check_fence_live seam):
        # victim deletes are plain store writes with no atomic fence
        # validation, so a superseded leader re-reads the lease before
        # evicting — the new leader's scheduler owns preemption now
        try:
            self._check_fence_live()
        except LeaderFenced:
            metrics.inc("scheduler_preemption_fenced_total")
            return ""
        with tracer.span(tid, "preempt.delete", victims=len(victims)):
            for victim in victims:
                if (
                    self.eviction_budget is not None
                    and not self.eviction_budget.try_acquire(actor="preemption")
                ):
                    # shared eviction budget dry: abort the attempt — the
                    # preemptor pod stays pending and retries; pressing on
                    # would let a preemption storm ride over the cluster's
                    # configured eviction rate alongside nodelifecycle and
                    # descheduler spends
                    metrics.inc("scheduler_preemption_budget_deferred_total")
                    return ""
                try:
                    self.server.delete(
                        "pods", victim.metadata.namespace, victim.metadata.name
                    )
                    prof.recorder.eventf(
                        victim, "Normal", "Preempted", "Preempting",
                        f"by {pod.metadata.key} on node {node}",
                    )
                    metrics.inc("preemption_victims_total")
                except NotFound:
                    pass
                except (DegradedWrites, NotPrimary):
                    # read-only store: abort the attempt (counted skip, the
                    # ride-through discipline) — the preemptor pod stays pending and
                    # retries once writes reopen; pressing on would nominate
                    # a node whose victims were never actually evicted
                    metrics.inc(
                        "scheduler_degraded_write_skips_total",
                        {"write": "preempt_delete"},
                    )
                    return ""
        metrics.inc("preemption_attempts_total")

        def mutate(p):
            p.status.nominated_node_name = node
            return p

        with tracer.span(tid, "preempt.nominate"):
            try:
                self.server.guaranteed_update(
                    "pods", pod.metadata.namespace, pod.metadata.name, mutate
                )
            except NotFound:
                return node
            except (DegradedWrites, NotPrimary):
                metrics.inc(
                    "scheduler_degraded_write_skips_total",
                    {"write": "nominate"},
                )
                return node  # victims are gone; nomination is best-effort
            self.queue.add_nominated_pod(pod, node)
        return node
