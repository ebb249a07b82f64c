"""Soak: sustained mixed churn against the full in-process control plane.

The port's counterpart of ``scripts/soak.py``, the reference's long-running
stability probe, as a function: ``run_soak(minutes, n_nodes=40,
device=None, seed=0, sample_s=5.0)``. It follows the reference step for
step. The cluster is ``n_nodes`` hollow nodes (``make_node_object(cpu="16")``,
``NodeAgentPool`` with 0.2 s housekeeping), the ``replicaset`` and
``deployment`` controllers, and ``Scheduler(server,
KubeSchedulerConfiguration(use_mesh=False), device=device)``: the default
wave path, so the fit-mask kernel (K1) launches on a card. Three churn
threads run at the reference's rates from one ``random.Random(seed)``:
pod create/delete churn that runs past capacity, node cordon flaps and
service churn. After ``minutes`` of churn it checks convergence as the
reference does:

- A, marking quiescence: every unbound pod carries its Unschedulable
  condition, the 60 s deadline extended while the count falls (600 s cap);
- B, the capacity-release probe: up to 400 owner-less bound pods deleted,
  and the freed capacity must refill from the unschedulable pool;
- C, up to three quiesce-and-audit rounds of the device snapshot against
  the host masters (``scheduler/cache/debugger.audit_device_vs_masters``),
  handed a host copy of the flushed snapshot (every field ``.cpu()``, taken
  under the cache lock), as the reference hands it ``jax.device_get``;

then the per-batch gate: the ``finish`` stage's CPU time at most 5.0 s and
its wall at most 60 s. The stage maxima are taken over the samples this
run observed, so earlier work in the same process does not count (in a
fresh process that is all of them, as in the reference).

Beside the reference's checks, a sampler thread records every
``sample_s``: on a card ``torch.cuda.memory_allocated``,
``memory_reserved`` and the pinned host bytes of
``torch.cuda.host_memory_stats`` (where the installed torch has it); on
every device the encoder's generation gauges and counters
(``snapshot_generation_current``, ``_pinned_readers``, ``_retiring``,
``_retired_total``, ``_retire_stalls_total``) and K1's launches. Two
criteria hold the card to a steady state: (a) after the first 2 minutes of
churn, allocated and pinned bytes never exceed their 2-minute values by
more than 64 MiB (``memory_steady``; None when the churn was shorter or the
device has no such counters); (b) ``snapshot_generation_retiring`` is 0 at
every quiesced audit that passes (``retiring_clear``).

``device=None`` means the CUDA card and raises without one; only an
explicit ``device="cpu"`` runs on the CPU. The steps are the methods of
``Soak`` (``churn``, ``converge``, ``audit_and_gate``, ``stop``), which
``scripts/torch_repro_mismatch.py`` also builds on.
"""

from __future__ import annotations

import gc
import random
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..api import objects as v1
from ..client.apiserver import APIServer, NotFound
from ..controller.manager import ControllerManager
from ..device import DeviceLike, resolve_device
from ..kubelet.kubelet import NodeAgentPool, make_node_object
from ..ops import fit_kernels
from ..ops.encoding import (
    COUNTER_GEN_RETIRE_STALLS,
    COUNTER_GEN_RETIRED,
    GAUGE_GEN_CURRENT,
    GAUGE_GEN_PINNED,
    GAUGE_GEN_RETIRING,
    DeviceSnapshot,
    gather_snapshot,
)
from ..scheduler import KubeSchedulerConfiguration, Scheduler
from .harness import _guard_counts, defense_counts
from ..scheduler.cache.debugger import audit_device_vs_masters
from ..utils.metrics import metrics

STAGES = (
    "encode", "kernel", "finish", "finish.resolve", "finish.snapshot",
    "finish.fallback", "finish.failed",
)
STEADY_AFTER_S = 120.0  # criterion (a) measures from the 2-minute sample on
STEADY_SLACK_BYTES = 64 << 20


# -- the cluster and its churn ----------------------------------------------


class SoakCluster:
    """The in-process control plane a soak churns: an API server with
    ``n_nodes`` nodes ``n0..`` of ``node_cpu`` CPUs, their hollow kubelets
    (housekeeping 0.2 s), the Scheduler on `device` (use_mesh off) and,
    when `controllers` is not empty, a ControllerManager running them."""

    def __init__(
        self,
        n_nodes: int,
        device: DeviceLike = None,
        node_cpu: str = "16",
        controllers: Sequence[str] = ("replicaset", "deployment"),
    ):
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.server = APIServer()
        for i in range(n_nodes):
            self.server.create("nodes", make_node_object(f"n{i}", cpu=node_cpu))
        self.pool = NodeAgentPool(self.server, housekeeping_interval=0.2)
        for i in range(n_nodes):
            self.pool.add_node(f"n{i}", register=False)
        self.pool.start()
        self.sched = Scheduler(
            self.server, KubeSchedulerConfiguration(use_mesh=False), device=self.device
        )
        self.sched.start()
        self.cm = None
        if controllers:
            self.cm = ControllerManager(self.server, controllers=list(controllers))
            self.cm.start()

    def stop(self) -> None:
        self.sched.stop()
        if self.cm is not None:
            self.cm.stop()
        self.pool.stop()

    def count_bound(self) -> int:
        return self.server.count("pods", lambda p: bool(p.spec.node_name))


class Churn:
    """The reference's churn loops over one cluster, each run on its own
    thread until ``stop()`` (scripts/soak.py:44-127): ``churn_pods`` creates
    ``churn-<i>`` (cpu 100m) and, past ``pod_window`` pods, deletes one of
    the last ``pod_window`` with probability 0.9, then sleeps
    ``pod_sleep_s``; ``flap_nodes`` cordons a random node for
    ``flap_hold_s`` and sleeps ``flap_sleep_s``; ``churn_services`` creates
    ``svc-<i>`` (selector app=a<i>, i < 8) or deletes it if it exists, then
    sleeps 0.7 s. The defaults are the soak's rates. A loop that raises
    stops and leaves its error in ``errors``."""

    def __init__(
        self,
        cluster: SoakCluster,
        seed: int = 0,
        pod_window: int = 60,
        pod_sleep_s: float = 0.02,
        flap_hold_s: float = 0.5,
        flap_sleep_s: float = 1.0,
    ):
        self.server = cluster.server
        self.n_nodes = cluster.n_nodes
        self.rng = random.Random(seed)
        self.pod_window = pod_window
        self.pod_sleep_s = pod_sleep_s
        self.flap_hold_s = flap_hold_s
        self.flap_sleep_s = flap_sleep_s
        self.seq = 0
        self.errors: List[str] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _guarded(self, fn: Callable[[], None]) -> Callable[[], None]:
        def run():
            try:
                while not self._stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 — reported as the run's error
                self.errors.append(f"{fn.__name__}: {type(e).__name__}: {e}")

        return run

    def churn_pods(self) -> None:
        i = self.seq = self.seq + 1
        try:
            self.server.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"churn-{i}"),
                    spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
                ),
            )
        except Exception:  # noqa: BLE001 — the reference ignores a refused create
            pass
        if i > self.pod_window and self.rng.random() < 0.9:
            victim = f"churn-{self.rng.randrange(max(1, i - self.pod_window), i)}"
            try:
                self.server.delete("pods", "default", victim)
            except NotFound:
                pass
        time.sleep(self.pod_sleep_s)

    def flap_nodes(self) -> None:
        name = f"n{self.rng.randrange(self.n_nodes)}"
        try:
            self.server.guaranteed_update(
                "nodes", "", name,
                lambda n: (setattr(n.spec, "unschedulable", True), n)[1],
            )
            time.sleep(self.flap_hold_s)
            self.server.guaranteed_update(
                "nodes", "", name,
                lambda n: (setattr(n.spec, "unschedulable", False), n)[1],
            )
        except NotFound:
            pass
        time.sleep(self.flap_sleep_s)

    def churn_services(self) -> None:
        i = self.rng.randrange(8)
        try:
            self.server.create(
                "services",
                v1.Service(
                    metadata=v1.ObjectMeta(name=f"svc-{i}"),
                    spec=v1.ServiceSpec(selector={"app": f"a{i}"}),
                ),
            )
        except Exception:  # noqa: BLE001 — it exists: delete it instead
            try:
                self.server.delete("services", "default", f"svc-{i}")
            except NotFound:
                pass
        time.sleep(0.7)

    def start(self, *loops: Callable[[], None]) -> None:
        for fn in loops:
            t = threading.Thread(
                target=self._guarded(fn), daemon=True, name=f"soak-{fn.__name__}"
            )
            t.start()
            self._threads.append(t)

    def stop(self, join_s: float = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=join_s)


# -- the audit ----------------------------------------------------------------


def host_snapshot(snap) -> DeviceSnapshot:
    """Every field of a flushed snapshot as a host tensor: what the audit
    reads with ``np.asarray`` (the reference's ``jax.device_get``)."""
    return DeviceSnapshot(*(t.cpu() for t in gather_snapshot(snap)))


def quiesce(sched: Scheduler, timeout_s: float) -> bool:
    """Wait until the pipeline holds no batch (nothing pending, not busy)
    on two samples 50 ms apart, ignoring the unschedulable queue, which
    an oversubscribed cluster never empties. False past `timeout_s`."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if not sched._pending and not sched._busy:
            time.sleep(0.05)
            if not sched._pending and not sched._busy:
                return True
        time.sleep(0.05)
    return False


def audit_once(
    sched: Scheduler,
    timeout_s: float = 60.0,
    fields: Tuple[str, ...] = ("requested", "sel_counts", "port_counts"),
) -> Optional[Tuple[List[str], Optional[float]]]:
    """One quiesce-and-audit round: None when the pipeline never
    quiesced within `timeout_s` (auditing mid-flight would report a
    designed transient, device commits not yet replayed, as a mismatch);
    else the differing field names and ``snapshot_generation_retiring``
    as it stood after the audit's flush, both read under the cache lock."""
    if not quiesce(sched, timeout_s):
        return None
    with sched.cache.lock:
        enc = sched.cache.encoder
        dev = host_snapshot(enc.flush())
        # diagnostics are printed while the lock still pins the state
        bad = audit_device_vs_masters(enc, dev, enc._masters(), fields=fields)
        return bad, metrics.gauge(GAUGE_GEN_RETIRING)


# -- the card's samples ---------------------------------------------------------


def _pinned_bytes() -> Optional[int]:
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    value = stats().get("allocated_bytes.current")
    return None if value is None else int(value)


class Sampler:
    """Records a sample every `period_s` on a thread of its own, and one
    on each ``take(phase)``: seconds since start, the phase, on a card the
    allocated, reserved and pinned host bytes, and everywhere the
    generation gauges, the generation counters, K1's launches since start,
    and the interpreter's full (generation 2) collections since start with
    the longest one's seconds: a full collection holds the interpreter
    lock, and whichever thread triggered it is charged its CPU time. A
    sample taken by ``take(phase)`` also counts the objects the collector
    tracks."""

    def __init__(self, device: torch.device, period_s: float):
        self.device = device
        self.period_s = period_s
        self.samples: List[dict] = []
        self.phase = "churn"
        self._t0 = time.monotonic()
        self._retired0 = metrics.counter(COUNTER_GEN_RETIRED)
        self._stalls0 = metrics.counter(COUNTER_GEN_RETIRE_STALLS)
        self._k1_0 = fit_kernels.fit_mask.launches
        self._gc_full = 0
        self._gc_full_max_s = 0.0
        self._gc_t0: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="soak-sampler")

    def start(self) -> None:
        self._t0 = time.monotonic()
        gc.callbacks.append(self._on_gc)
        self._thread.start()

    def _on_gc(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_full += 1
            self._gc_full_max_s = max(self._gc_full_max_s, time.perf_counter() - self._gc_t0)
            self._gc_t0 = None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.take()

    def take(self, phase: Optional[str] = None) -> dict:
        s = {"t_s": round(time.monotonic() - self._t0, 3), "phase": phase or self.phase}
        if self.device.type == "cuda":
            s["memory_allocated"] = torch.cuda.memory_allocated(self.device)
            s["memory_reserved"] = torch.cuda.memory_reserved(self.device)
            s["pinned_bytes"] = _pinned_bytes()
        s["generation_current"] = metrics.gauge(GAUGE_GEN_CURRENT)
        s["generation_pinned_readers"] = metrics.gauge(GAUGE_GEN_PINNED)
        s["generation_retiring"] = metrics.gauge(GAUGE_GEN_RETIRING)
        s["generation_retired"] = int(metrics.counter(COUNTER_GEN_RETIRED) - self._retired0)
        s["generation_retire_stalls"] = int(
            metrics.counter(COUNTER_GEN_RETIRE_STALLS) - self._stalls0
        )
        s["k1_launches"] = fit_kernels.fit_mask.launches - self._k1_0
        s["gc_full_collections"] = self._gc_full
        s["gc_full_max_s"] = round(self._gc_full_max_s, 3)
        if phase is not None:
            s["gc_objects"] = len(gc.get_objects())
        with self._lock:
            self.samples.append(s)
        return s

    def stop(self) -> List[dict]:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.period_s + 5.0)
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        with self._lock:
            return list(self.samples)


def memory_steady(samples: Sequence[dict], after_s: float = STEADY_AFTER_S) -> Optional[bool]:
    """Criterion (a): from the first sample at or past `after_s` on, no
    sample's allocated or pinned host bytes exceed that sample's by more
    than 64 MiB. None when no sample holds device memory or none reaches
    `after_s`."""
    base = next(
        (s for s in samples if s["t_s"] >= after_s and "memory_allocated" in s), None
    )
    if base is None:
        return None
    for s in samples:
        if s["t_s"] < base["t_s"] or "memory_allocated" not in s:
            continue
        if s["memory_allocated"] - base["memory_allocated"] > STEADY_SLACK_BYTES:
            return False
        if (
            s["pinned_bytes"] is not None
            and base["pinned_bytes"] is not None
            and s["pinned_bytes"] - base["pinned_bytes"] > STEADY_SLACK_BYTES
        ):
            return False
    return True


def sample_at(samples: Sequence[dict], t_s: float) -> Optional[dict]:
    """The first sample at or past `t_s` seconds (None if none is)."""
    return next((s for s in samples if s["t_s"] >= t_s), None)


def peak_sample(samples: Sequence[dict]) -> Optional[dict]:
    """The sample with the most allocated device bytes (None without
    device memory samples)."""
    on_card = [s for s in samples if "memory_allocated" in s]
    return max(on_card, key=lambda s: s["memory_allocated"]) if on_card else None


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    ("unknown" where it cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown"


# -- the result ---------------------------------------------------------------


@dataclass
class SoakResult:
    """Every field of the reference's ``SOAK PASS/FAIL`` line (``ok`` is
    its verdict), then the run's shape, the samples, each audit round
    (``{"mismatch", "retiring"}``; ``mismatch`` None when it never
    quiesced), criteria (a) and (b), K1's launches and the data-plane
    defense over the run (``defense``: the snapshot auditor's passes,
    drift rows and rebuilds, kernel guard trips, and whether the device
    latched down)."""

    ok: bool
    created: int
    pending: int
    unmarked: int
    marking_s: float
    refill_ok: bool
    refilled: int
    stage_max_s: Dict[str, float]
    stage_cpu_max_s: Dict[str, float]
    starvation_max_s: float
    errors: List[str]
    device_host_mismatch: List[str]
    device: str = ""
    minutes: float = 0.0
    n_nodes: int = 0
    churn_s: float = 0.0
    samples: List[dict] = field(default_factory=list)
    audits: List[dict] = field(default_factory=list)
    memory_steady: Optional[bool] = None
    retiring_clear: bool = True
    k1_launches: int = 0
    defense: Dict[str, int] = field(default_factory=dict)

    def line(self) -> str:
        """The reference's ``SOAK PASS/FAIL`` line, its fields and format."""
        return (
            f"SOAK {'PASS' if self.ok else 'FAIL'}: created={self.created} "
            f"pending={self.pending} unmarked={self.unmarked} "
            f"marking_s={self.marking_s:.0f} "
            f"refill_ok={self.refill_ok} refilled={self.refilled} "
            f"stage_max_s={self.stage_max_s} stage_cpu_max_s={self.stage_cpu_max_s} "
            f"starvation_max_s={self.starvation_max_s:.1f} "
            f"errors={self.errors[:3]} device_host_mismatch={self.device_host_mismatch}"
        )


# -- the run ------------------------------------------------------------------


def _stage_counts() -> Dict[Tuple[str, str], int]:
    out = {}
    for name in ("scheduling_stage_duration_seconds", "scheduling_stage_cpu_seconds"):
        for st in STAGES:
            h = metrics.histogram(name, {"stage": st})
            out[(name, st)] = 0 if h is None else h.n
    return out


def _defense() -> Dict[str, int]:
    d = defense_counts()
    return {
        "audit_passes": d["audit_passes"],
        "drift_rows": d["drift_rows"],
        "rebuilds": d["rebuilds"],
        "guard_trips": _guard_counts()[0],
    }


def _stage_max(name: str, st: str, since: Dict[Tuple[str, str], int]) -> Optional[float]:
    """The largest sample of one stage histogram observed after `since`."""
    h = metrics.histogram(name, {"stage": st})
    if h is None:
        return None
    first = since.get((name, st), 0)
    xs = [v for v, i in zip(h._samples, h._sample_obs) if i >= first]
    return round(max(xs), 3) if xs else None


class Soak:
    """One soak run of the reference's shape, step by step: ``churn``,
    ``converge`` (A and B), ``audit_and_gate`` (C and the stage gate, which
    returns the result), ``stop``. ``run_soak`` runs them in order."""

    def __init__(
        self,
        n_nodes: int = 40,
        device: DeviceLike = None,
        seed: int = 0,
        sample_s: float = 5.0,
    ):
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self._stage0 = _stage_counts()
        self._defense0 = _defense()
        self.cluster = SoakCluster(n_nodes, self.device)
        self.server, self.sched = self.cluster.server, self.cluster.sched
        self.churner = Churn(self.cluster, seed=seed)
        self.sampler = Sampler(self.device, sample_s)
        # starvation sentinel: on a saturated box a thread can sit
        # descheduled for seconds between two bytecodes, which inflates
        # every wall-clock stage timer without any work happening. It
        # measures the largest sleep overshoot through convergence too
        # (the refill probe's full-store counts starve the scheduler
        # hardest) and stops after the stage histograms are read.
        self.starve_max_s = 0.0
        self._sentinel_stop = threading.Event()
        threading.Thread(target=self._sentinel, daemon=True, name="soak-sentinel").start()
        self.minutes = 0.0
        self.churn_s = 0.0
        self.unmarked = 0
        self.marking_s = 0.0
        self.pending = 0
        self.refill_ok = True
        self.refilled = 0
        self._stopped = False

    def _sentinel(self) -> None:
        while not self._sentinel_stop.is_set():
            t = time.monotonic()
            time.sleep(0.25)
            over = time.monotonic() - t - 0.25
            if over > self.starve_max_s:
                self.starve_max_s = over

    def churn(self, minutes: float) -> None:
        """The three churn threads for `minutes`, a progress line a minute."""
        self.minutes = minutes
        c = self.churner
        self.sampler.start()
        c.start(c.churn_pods, c.flap_nodes, c.churn_services)
        t0 = time.time()
        last_report = t0
        while time.time() - t0 < minutes * 60 and not c.errors:
            time.sleep(min(5.0, max(0.0, t0 + minutes * 60 - time.time())))
            if time.time() - last_report > 60:
                last_report = time.time()
                print(
                    f"[{(time.time() - t0) / 60:.1f}m] pods={self.server.count('pods')} "
                    f"bound={self.cluster.count_bound()} created={c.seq} "
                    f"errors={len(c.errors)}",
                    flush=True,
                )
        c.stop()
        self.churn_s = time.time() - t0
        self.sampler.take("churn-end")
        self.sampler.phase = "converge"

    def _unmarked_count(self) -> int:
        def pending_unmarked(p) -> bool:
            if p.spec.node_name or p.metadata.deletion_timestamp is not None:
                return False
            for c in p.status.conditions:
                if (
                    c.type == v1.COND_POD_SCHEDULED
                    and c.status == "False"
                    and c.reason == "Unschedulable"
                ):
                    return False
            return True

        return self.server.count("pods", pending_unmarked)

    def converge(self) -> None:
        """A: every unbound pod marked Unschedulable (the deadline extends
        only while the count falls); B: free capacity and require the
        unschedulable pool to refill it."""
        t_conv = time.time()
        deadline = t_conv + 60
        hard_cap = t_conv + 600
        unmarked = last = self._unmarked_count()
        while unmarked and time.time() < min(deadline, hard_cap):
            # 3 s poll: a full-store count with a Python predicate per
            # second measurably starves the scheduler on a small box
            time.sleep(3)
            unmarked = self._unmarked_count()
            if unmarked < last:  # progress: extend, never past the hard cap
                deadline = time.time() + 60
            last = unmarked
        self.unmarked = unmarked
        self.marking_s = time.time() - t_conv
        server = self.server
        pending = self.pending = server.count(
            "pods",
            lambda p: not p.spec.node_name and p.metadata.deletion_timestamp is None,
        )
        bound0 = self.cluster.count_bound()
        if not (pending > 0 and unmarked == 0):
            return
        k = min(400, pending, max(1, bound0 // 4))
        # owner-less victims only: a controller-owned pod would be recreated
        # by the live controllers and refill the capacity itself, passing
        # the probe without exercising the storm-requeue path
        victims = [
            p
            for p in server.list("pods")[0]
            if p.spec.node_name
            and p.metadata.deletion_timestamp is None
            and not p.metadata.owner_references
        ][:k]
        for p in victims:
            try:
                server.delete("pods", p.metadata.namespace, p.metadata.name)
            except NotFound:
                pass
        want = bound0 - len(victims) + int(0.9 * min(len(victims), pending))
        probe_deadline = time.time() + max(120.0, 0.2 * len(victims))
        while time.time() < probe_deadline:
            bound_now = server.count(
                "pods",
                lambda p: bool(p.spec.node_name) and p.metadata.deletion_timestamp is None,
            )
            self.refilled = bound_now - (bound0 - len(victims))
            if bound_now >= want:
                break
            time.sleep(3)
        else:
            self.refill_ok = False

    def audit_and_gate(self) -> SoakResult:
        """C: up to three quiesce-and-audit rounds, a mismatch real only if
        it survives all three; then the stage gate. Returns the result."""
        audits = []
        mismatch: Optional[List[str]] = []
        for _ in range(3):
            got = audit_once(self.sched)
            if got is None:
                print("audit: pipeline never quiesced", flush=True)
                mismatch = None
                audits.append({"mismatch": None, "retiring": None})
            else:
                mismatch, retiring = got
                audits.append({"mismatch": mismatch, "retiring": retiring})
                if not mismatch:
                    break
            time.sleep(2)
        if mismatch is None:
            mismatch = ["audit-never-quiesced"]
        self.sampler.take("audited")

        stage_max, stage_cpu_max = {}, {}
        for st in STAGES:
            v = _stage_max("scheduling_stage_duration_seconds", st, self._stage0)
            if v is not None:
                stage_max[st] = v
            v = _stage_max("scheduling_stage_cpu_seconds", st, self._stage0)
            if v is not None:
                stage_cpu_max[st] = v
        # absence of finish samples is itself a FAIL: a renamed stage label
        # would otherwise disable this gate
        batch_ok = (
            "finish" in stage_max
            and "finish" in stage_cpu_max
            and stage_cpu_max["finish"] <= 5.0
            and stage_max["finish"] <= 60.0
        )
        self._sentinel_stop.set()
        if stage_max.get("finish", 0.0) > 1.0:
            print(
                f"WARNING: finish wall {stage_max['finish']}s (cpu "
                f"{stage_cpu_max.get('finish', 0.0)}s, sentinel starvation max "
                f"{self.starve_max_s:.1f}s)",
                flush=True,
            )
        samples = self.sampler.stop()
        defense = {k: v - self._defense0[k] for k, v in _defense().items()}
        defense["device_down"] = int(self.sched._device_down)
        errors = list(self.churner.errors)
        ok = (
            not errors
            and self.unmarked == 0
            and self.refill_ok
            and not mismatch
            and batch_ok
        )
        passed_audits = [a for a in audits if a["mismatch"] == []]
        return SoakResult(
            ok=ok,
            created=self.churner.seq,
            pending=self.pending,
            unmarked=self.unmarked,
            marking_s=self.marking_s,
            refill_ok=self.refill_ok,
            refilled=self.refilled,
            stage_max_s=stage_max,
            stage_cpu_max_s=stage_cpu_max,
            starvation_max_s=self.starve_max_s,
            errors=errors,
            device_host_mismatch=mismatch,
            device=(
                torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda"
                else str(self.device)
            ),
            minutes=self.minutes,
            n_nodes=self.n_nodes,
            churn_s=self.churn_s,
            samples=samples,
            audits=audits,
            memory_steady=memory_steady(samples),
            retiring_clear=all(a["retiring"] == 0 for a in passed_audits),
            k1_launches=samples[-1]["k1_launches"] if samples else 0,
            defense=defense,
        )

    def stop(self) -> None:
        """Stop everything the run started (idempotent)."""
        if self._stopped:
            return
        self._stopped = True
        self.churner.stop()
        self._sentinel_stop.set()
        self.sampler.stop()
        self.cluster.stop()


def run_soak(
    minutes: float,
    n_nodes: int = 40,
    device: DeviceLike = None,
    seed: int = 0,
    sample_s: float = 5.0,
) -> SoakResult:
    """``scripts/soak.py`` as a function: `minutes` of churn on `n_nodes`
    nodes, convergence steps A, B and C and the stage gate, with the card's
    samples every `sample_s` seconds. ``device=None`` means the CUDA card."""
    soak = Soak(n_nodes, device=device, seed=seed, sample_s=sample_s)
    try:
        soak.churn(minutes)
        soak.converge()
        return soak.audit_and_gate()
    finally:
        soak.stop()
