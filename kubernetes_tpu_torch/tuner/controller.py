"""PolicyTuner (port): the gym loop + the shadow A/B promotion gate.

PyTorch port of ``kubernetes_tpu/tuner/controller.py``. The gate, the
shadow windows, the persist-first promotion, the rollback watch, the
candidate assembly and the counters are the reference's, line for line.
What changed is the tick's tie noise. The reference replays every arm of a
tick under one PRNG key, ``PRNGKey(seed * 1_000_003 + tick)``; here every
arm of a tick replays one ``[P, N]`` noise tensor, drawn once per tick:

* by default from a ``torch.Generator`` the TUNER owns, on the encoder's
  device, seeded ``seed * 1_000_003 + tick`` (never the Scheduler's own
  Generator: drawing from it would change production's tie noise whenever
  the tuner runs, and two threads would share one Generator);
* or from a ``noise(tick, P, N)`` source given at construction (the tests
  inject the reference's key chain).

One draw for all arms keeps the arms comparable: a draw per arm would
rank noise as well as weights.

The reference's design notes follow.

The first closed feedback loop in the system: the scheduler records its
real waves (tuner/waves.py), a background tick replays K candidate
weight vectors against them over ONE shared overlay snapshot
(tuner/scoring.py — K cheap re-launches, zero recompiles), and the
winner has to EARN the live slot:

  1. a candidate that beats the incumbent beyond the noise floor enters
     SHADOW — scored on subsequent live waves without acting, its
     hypothetical placements diffed against production's;
  2. it promotes through ``Scheduler.set_score_policy`` only after
     beating the incumbent in N consecutive shadow windows; ONE lost
     window discards it (incumbent kept — a diverging shadow never
     ships);
  3. promotion persists the vector as the ScorePolicy API object FIRST
     (degraded store → counted skip, tuner pauses, retried) and applies
     second, so failover adopts the tuned vector instead of reverting;
  4. a post-promotion watch compares live production utility against the
     pre-promotion baseline and ROLLS BACK automatically on regression.

Candidate vectors are validated through ``weights_for_policy`` before
they may even be replayed — a poisoned (NaN/inf/mis-shaped) candidate
dies at the gate with a counted rejection, never inside a kernel.
"""


from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.lattice import (
    WEIGHT_PROFILES,
    register_weight_profile,
    weights_for_policy,
)
from ..testing.lockgraph import named_lock, track_attrs
from ..utils.metrics import metrics
from . import candidates as cand_gen
from .policy import (
    COUNTER_CANDIDATES_REJECTED,
    COUNTER_GYM_CANDIDATES,
    COUNTER_GYM_PASSES,
    COUNTER_POLICY_PROMOTIONS,
    COUNTER_ROLLBACKS,
    COUNTER_SHADOW_WINDOWS,
    COUNTER_TICK_ERRORS,
    GAUGE_ARM_UTILITY,
    GAUGE_SHADOW_DIVERGENCE,
    HIST_GYM_PASS_SECONDS,
    persist_active_policy,
)
from .scoring import (
    build_overlay,
    divergence,
    replay_candidate,
    rows_for_placements,
    score_assignment,
)
from .waves import WaveRingBuffer

logger = logging.getLogger("kubernetes_tpu_torch.tuner")


class PolicyTuner:
    """Background self-tuning loop bound to one (leading) scheduler.

    Lifecycle follows leadership: cmd/scheduler.py starts it next to the
    autoscaler when scheduling starts and stops it when leadership (or
    the process) ends. ``start`` attaches the wave ring as the
    scheduler's recorder; ``stop`` detaches it. ``noise``: the tick's
    tie-noise source, called as ``noise(tick, P, N)`` for a ``[P, N]``
    float32 tensor in [0, 1) on the encoder's device (None: the tuner's
    own Generator, seeded ``seed * 1_000_003 + tick``)."""

    def __init__(
        self,
        scheduler,
        server,
        *,
        period_s: float = 2.0,
        ring_capacity: int = 32,
        max_waves_per_pass: int = 8,
        max_pods_per_pass: int = 128,
        k_perturb: int = 3,
        shadow_windows: int = 3,
        noise_floor: float = 0.02,
        min_waves: int = 1,
        rollback_windows: int = 3,
        rollback_margin: float = 0.2,
        degraded_pause_ticks: int = 3,
        seed: int = 0,
        noise: Optional[Callable[[int, int, int], torch.Tensor]] = None,
    ):
        self.sched = scheduler
        self.server = server
        self.period_s = period_s
        self.max_waves_per_pass = max_waves_per_pass
        self.max_pods_per_pass = max_pods_per_pass
        self.k_perturb = k_perturb
        self.shadow_windows = shadow_windows
        self.noise_floor = noise_floor
        self.min_waves = min_waves
        self.rollback_windows = rollback_windows
        self.rollback_margin = rollback_margin
        self.degraded_pause_ticks = degraded_pause_ticks
        self.seed = seed
        self.ring = WaveRingBuffer(ring_capacity)
        self._lock = named_lock("tuner.state")
        self._rng = np.random.default_rng(seed)
        self._injected: List[Tuple[str, object]] = []
        self._shadow: Optional[dict] = None
        self._post: Optional[dict] = None  # post-promotion rollback watch
        self._pause_ticks = 0
        self._cand_seq = 0
        self._tick_count = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._noise = noise
        self._gen: Optional[torch.Generator] = None  # gym thread only

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.sched.wave_recorder = self.ring
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="policy-tuner"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if getattr(self.sched, "wave_recorder", None) is self.ring:
            self.sched.wave_recorder = None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:
                metrics.inc(COUNTER_TICK_ERRORS)
                logger.exception("tuner tick failed (loop continues)")

    # -- chaos/test seam -----------------------------------------------------

    def inject_candidate(self, vec, name: str = "") -> None:
        """Queue an external candidate for the next gym pass (the chaos
        suites poison this with NaN vectors; the gate must reject them)."""
        with self._lock:
            self._injected.append((name or "injected", vec))

    # -- one gym pass --------------------------------------------------------

    def tick(self) -> None:
        with self._lock:
            if self._pause_ticks > 0:
                self._pause_ticks -= 1
                return
        waves = self.ring.snapshot(limit=self.max_waves_per_pass)
        if len(waves) < self.min_waves:
            return
        incumbent_vec = np.asarray(self.sched._weights, np.float32).copy()
        incumbent_name = getattr(
            self.sched, "_score_policy_name", "default"
        )
        # newest waves first, capped: one concatenated pseudo-wave — the
        # serial kernel's in-batch carry replays them in sequence against
        # the shared overlay
        pods: List = []
        placements: List[str] = []
        for rec in reversed(waves):
            if pods and len(pods) + len(rec.pods) > self.max_pods_per_pass:
                break
            pods.extend(rec.pods)
            placements.extend(rec.placements)
        if len(pods) > self.max_pods_per_pass:
            pods = pods[: self.max_pods_per_pass]
            placements = placements[: self.max_pods_per_pass]
        t0 = time.monotonic()
        ov = build_overlay(self.sched.cache, pods)
        if ov is None:
            return

        arms = self._assemble_candidates(incumbent_name, incumbent_vec, ov)

        with self._lock:
            self._tick_count += 1
            tick = self._tick_count
        noise = self._tick_noise(tick, ov)
        hard_w = self.sched.cfg.hard_pod_affinity_weight
        scored = []
        for source, name, vec in arms:
            chosen = replay_candidate(ov, vec, noise, hard_w)
            scored.append(
                (source, name, vec, chosen, score_assignment(ov, chosen))
            )
        prod_rows = rows_for_placements(ov, placements)
        prod_outcome = score_assignment(ov, prod_rows)
        metrics.inc(COUNTER_GYM_PASSES)
        metrics.observe(HIST_GYM_PASS_SECONDS, time.monotonic() - t0)
        metrics.set_gauge(
            GAUGE_ARM_UTILITY, prod_outcome.utility, {"arm": "production"}
        )
        inc_outcome = scored[0][4]
        metrics.set_gauge(
            GAUGE_ARM_UTILITY, inc_outcome.utility, {"arm": "incumbent"}
        )
        self._decide(
            incumbent_name,
            incumbent_vec,
            scored,
            ov,
            prod_rows,
            prod_outcome,
        )

    def _tick_noise(self, tick: int, ov) -> torch.Tensor:
        """The [P, N] tie noise every arm of this tick replays."""
        dev = ov.snap.valid.device
        p, n = int(ov.batch.valid.shape[0]), int(ov.snap.valid.shape[0])
        if self._noise is not None:
            return self._noise(tick, p, n)
        if self._gen is None:
            self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.seed * 1_000_003 + tick)
        return torch.rand(
            (p, n), generator=self._gen, device=dev, dtype=torch.float32
        )

    def _assemble_candidates(self, incumbent_name, incumbent_vec, ov):
        """Gather + validate + dedupe the candidate arms. Index 0 is
        always the incumbent (the comparison baseline on the same
        overlay); a shadow challenger, if any, is always included."""
        with self._lock:
            shadow = self._shadow
            injected = list(self._injected)
            self._injected = []
            perturbs = cand_gen.perturbation_candidates(
                incumbent_vec, self._rng, self.k_perturb
            )
        raw: List[Tuple[str, str, object]] = [
            ("incumbent", incumbent_name, incumbent_vec)
        ]
        if shadow is not None:
            raw.append(("shadow", shadow["name"], shadow["vec"]))
        raw.extend(
            ("profile", name, vec)
            for name, vec in cand_gen.profile_candidates()
        )
        raw.extend(
            ("topsis", "", vec)
            for vec in cand_gen.topsis_candidates(
                ov.alloc - ov.free0,  # requested
                ov.alloc,
                ov.node_valid,
                ov.cost_milli,
                ov.energy_milli,
            )
        )
        raw.extend(
            ("gavel", "", vec)
            for vec in cand_gen.gavel_candidates(
                ov.cost_milli,
                ov.energy_milli,
                ov.accel_class,
                ov.node_valid,
            )
        )
        raw.extend(("perturb", "", vec) for vec in perturbs)
        raw.extend(("injected", name, vec) for name, vec in injected)
        out: List[Tuple[str, str, np.ndarray]] = []
        seen = set()
        for source, name, vec in raw:
            try:
                v = weights_for_policy(np.asarray(vec))
            except (ValueError, TypeError):
                # THE gate: a poisoned candidate is rejected before it
                # may touch a kernel, a shadow window, or the live slot
                metrics.inc(
                    COUNTER_CANDIDATES_REJECTED, {"reason": "invalid"}
                )
                if source == "shadow":
                    with self._lock:
                        self._shadow = None
                continue
            dedup = tuple(np.round(v, 4).tolist())
            if dedup in seen and source not in ("incumbent", "shadow"):
                continue
            seen.add(dedup)
            out.append((source, name, v))
            metrics.inc(COUNTER_GYM_CANDIDATES, {"source": source})
        return out

    # -- the gate ------------------------------------------------------------

    def _decide(
        self,
        incumbent_name,
        incumbent_vec,
        scored,
        ov,
        prod_rows,
        prod_outcome,
    ) -> None:
        inc_outcome = scored[0][4]
        # post-promotion rollback watch: live production utility vs the
        # pre-promotion baseline
        with self._lock:
            post = self._post
        if post is not None and self.ring.last_seq() > post["seq"]:
            if prod_outcome.utility < post["baseline"] - self.rollback_margin:
                post["bad"] += 1
                post["good"] = 0
            else:
                post["bad"] = 0
                post["good"] += 1
            if post["bad"] >= self.rollback_windows:
                self._rollback(post)
                return
            if post["good"] >= 2 * self.rollback_windows:
                with self._lock:
                    self._post = None  # promotion held up — watch ends

        by_shadow = next((s for s in scored if s[0] == "shadow"), None)
        if by_shadow is not None:
            _, name, vec, chosen, outcome = by_shadow
            div = divergence(ov, chosen, prod_rows)
            metrics.set_gauge(GAUGE_SHADOW_DIVERGENCE, div)
            metrics.set_gauge(
                GAUGE_ARM_UTILITY, outcome.utility, {"arm": "shadow"}
            )
            if outcome.utility - inc_outcome.utility > self.noise_floor:
                metrics.inc(COUNTER_SHADOW_WINDOWS, {"outcome": "win"})
                with self._lock:
                    if self._shadow is not None:
                        self._shadow["wins"] += 1
                        wins = self._shadow["wins"]
                    else:
                        wins = 0
                if wins >= self.shadow_windows:
                    self._promote(
                        name, vec, incumbent_name, incumbent_vec,
                        prod_outcome,
                    )
            else:
                # one lost window discards the challenger: a shadow that
                # diverges from "better" even once is not promoted
                metrics.inc(COUNTER_SHADOW_WINDOWS, {"outcome": "loss"})
                with self._lock:
                    self._shadow = None
            return

        # no shadow in flight: does any candidate beat the incumbent
        # beyond the noise floor on this window?
        challengers = [s for s in scored[1:] if s[0] != "shadow"]
        if not challengers:
            return
        best = max(challengers, key=lambda s: s[4].utility)
        source, name, vec, _chosen, outcome = best
        if outcome.utility - inc_outcome.utility <= self.noise_floor:
            return
        with self._lock:
            if not name:
                self._cand_seq += 1
                name = f"tuned-{self._cand_seq}"
            self._shadow = {
                "name": name,
                "vec": np.asarray(vec, np.float32).copy(),
                "wins": 1,
                "source": source,
            }
        logger.info(
            "tuner: candidate %s (%s) entered shadow (utility %.4f vs "
            "incumbent %.4f)",
            name, source, outcome.utility, inc_outcome.utility,
        )

    def _promote(
        self, name, vec, incumbent_name, incumbent_vec, prod_outcome
    ) -> None:
        try:
            vec = weights_for_policy(np.asarray(vec))
        except (ValueError, TypeError):
            metrics.inc(
                COUNTER_CANDIDATES_REJECTED, {"reason": "gate_invalid"}
            )
            with self._lock:
                self._shadow = None
            return
        identity = getattr(self.sched, "_ha_identity", "scheduler-0")
        # persist FIRST: a vector the store refused must not become the
        # only copy (failover would silently revert it) — degraded store
        # pauses the tuner; the shadow state survives for the retry
        if not persist_active_policy(self.server, name, vec, identity):
            with self._lock:
                self._pause_ticks = self.degraded_pause_ticks
            return
        if name not in WEIGHT_PROFILES or not np.array_equal(
            WEIGHT_PROFILES.get(name), vec
        ):
            register_weight_profile(name, vec, overwrite=True)
        self.sched.set_score_policy(name)
        metrics.inc(COUNTER_POLICY_PROMOTIONS)
        with self._lock:
            self._shadow = None
            self._post = {
                "prev_name": incumbent_name,
                "prev_vec": np.asarray(incumbent_vec, np.float32).copy(),
                "baseline": prod_outcome.utility,
                "bad": 0,
                "good": 0,
                "seq": self.ring.last_seq(),
            }
        logger.warning(
            "tuner: promoted score policy %r (was %r); rollback watch "
            "armed at baseline %.4f", name, incumbent_name,
            prod_outcome.utility,
        )

    def _rollback(self, post: dict) -> None:
        prev_name, prev_vec = post["prev_name"], post["prev_vec"]
        identity = getattr(self.sched, "_ha_identity", "scheduler-0")
        if not persist_active_policy(
            self.server, prev_name, prev_vec, identity
        ):
            with self._lock:
                self._pause_ticks = self.degraded_pause_ticks
            return
        if prev_name not in WEIGHT_PROFILES:
            register_weight_profile(prev_name, prev_vec, overwrite=True)
        try:
            self.sched.set_score_policy(prev_name)
        except ValueError:
            self.sched.set_score_policy(prev_vec)
        metrics.inc(COUNTER_ROLLBACKS)
        with self._lock:
            self._post = None
            self._shadow = None
        logger.error(
            "tuner: post-promotion regression — rolled back to %r",
            prev_name,
        )


track_attrs(PolicyTuner, "_shadow", "_post", "_injected")
