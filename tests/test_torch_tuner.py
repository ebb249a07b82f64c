"""The port's policy gym (kubernetes_tpu_torch/tuner/) on the CPU, against
the reference.

(a) Every case of tests/test_tuner.py on the port's objects: weight
    validation and profile registration, the candidate generators, outcome
    scoring, the wave ring, ScorePolicy persistence and adoption, and the
    shadow A/B gate's state machine driven directly.
(b) Parity with the reference on one cluster (tests/test_torch_encoding.py's
    build_cluster, its nodes given cost, energy and accelerator labels, fed
    to a reference and a port SchedulerCache; pods made from a seed):
    ``build_overlay``'s host columns; the candidate arms the tuner
    assembles; ``replay_candidate`` for every arm with the reference's tie
    noise (``reference_noise`` of the tick key); ``score_assignment``,
    ``divergence`` and ``rows_for_placements``; and ``PolicyTuner.tick``
    over several ticks from one injected ring with the reference's key
    chain: the same arms in the same order, the same utilities, and the
    same shadow, promotion and rollback decisions. The live snapshot is
    bit-identical after every replay.
(c) Replay of a recorded serial wave on the port's own Generator key: the
    Scheduler (use_wave=False) records the Generator state taken before
    its draw, and ``replay_wave`` of that record reproduces production's
    placements exactly, twice; the ring holds no device tensor. An
    injected noise source that offers ``replay_key()`` is recorded as its
    redraw callable, which replays production too.
(d) ``perf/harness.run_tuner_benchmark`` at the reference's defaults on
    the CPU: every burst bound, no promotion before the flip, a
    cost-aware promotion after it.

Tolerances: exact. Chosen rows, outcomes (floats computed on equal
integers) and gate decisions are compared with ``==``.
"""

import importlib
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.tuner import controller as ref_controller
from kubernetes_tpu.tuner import scoring as ref_scoring
from kubernetes_tpu.tuner import waves as ref_waves
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.ops.lattice import (
    DEFAULT_WEIGHTS,
    NUM_SCORE_COMPONENTS,
    SC_COST,
    WEIGHT_PROFILES,
    register_weight_profile,
    weights_for_policy,
)
from kubernetes_tpu_torch.runtime.consensus import DegradedWrites
from kubernetes_tpu_torch.tuner import (
    ACTIVE_POLICY_NAME,
    ScorePolicy,
    adopt_persisted_policy,
    persist_active_policy,
    read_persisted_policy,
    tuner_health_lines,
)
from kubernetes_tpu_torch.tuner import candidates as cand_gen
from kubernetes_tpu_torch.tuner import scoring as port_scoring
from kubernetes_tpu_torch.tuner.controller import PolicyTuner
from kubernetes_tpu_torch.tuner.scoring import (
    OverlaySnapshot,
    WaveOutcome,
    divergence,
    score_assignment,
)
from kubernetes_tpu_torch.tuner.waves import WaveRingBuffer
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_encoding import PACKAGES, build_cluster
from test_torch_serial_lattice import reference_noise
from test_torch_whatif import assert_live_untouched, live_tensors, port_cache, ref_cache

REF, PORT = PACKAGES


# -- satellite 1: call-time validation + profile registration -----------------


def test_weights_for_policy_rejects_wrong_length():
    with pytest.raises(ValueError):
        weights_for_policy(np.ones(NUM_SCORE_COMPONENTS - 1, np.float32))


def test_weights_for_policy_rejects_non_finite():
    bad = np.ones(NUM_SCORE_COMPONENTS, np.float32)
    bad[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        weights_for_policy(bad)
    bad[3] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        weights_for_policy(bad)


def test_weights_for_policy_rejects_uncoercible():
    with pytest.raises(ValueError):
        weights_for_policy(["not", "a", "vector"])


def test_register_weight_profile_roundtrip():
    vec = DEFAULT_WEIGHTS.copy()
    vec[SC_COST] = 42.0
    got = register_weight_profile("t-roundtrip", vec)
    try:
        assert np.array_equal(got, weights_for_policy("t-roundtrip"))
        # idempotent same-vector re-register is fine
        register_weight_profile("t-roundtrip", vec)
        # silently replacing a DIFFERENT vector is not
        vec2 = vec.copy()
        vec2[SC_COST] = 7.0
        with pytest.raises(ValueError, match="overwrite"):
            register_weight_profile("t-roundtrip", vec2)
        register_weight_profile("t-roundtrip", vec2, overwrite=True)
        assert weights_for_policy("t-roundtrip")[SC_COST] == 7.0
    finally:
        WEIGHT_PROFILES.pop("t-roundtrip", None)


def test_register_weight_profile_guards_names():
    with pytest.raises(ValueError, match="reserved"):
        register_weight_profile("default", DEFAULT_WEIGHTS.copy())
    with pytest.raises(ValueError):
        register_weight_profile("", DEFAULT_WEIGHTS.copy())
    with pytest.raises(ValueError, match="non-finite"):
        register_weight_profile(
            "t-nan", np.full(NUM_SCORE_COMPONENTS, np.nan)
        )
    assert "t-nan" not in WEIGHT_PROFILES


# -- candidate generators -----------------------------------------------------


def test_perturbation_candidates_deterministic_and_zero_preserving():
    a = cand_gen.perturbation_candidates(
        DEFAULT_WEIGHTS, np.random.default_rng(7), 3
    )
    b = cand_gen.perturbation_candidates(
        DEFAULT_WEIGHTS, np.random.default_rng(7), 3
    )
    assert len(a) == 3
    for x, y in zip(a, b):
        assert np.array_equal(x, y), "same seed must give same candidates"
        assert np.isfinite(x).all()
        # multiplicative jitter: disabled components stay disabled
        assert (x[DEFAULT_WEIGHTS == 0] == 0).all()


def test_topsis_candidates_weight_dispersed_criteria():
    n = 6
    cost = np.array([100, 200, 400, 800, 1600, 3200])  # wildly dispersed
    cands = cand_gen.topsis_candidates(
        requested=np.zeros((n, 3)),
        allocatable=np.full((n, 3), 10.0),
        valid=np.ones(n, bool),
        cost_milli=cost,
        energy_milli=np.zeros(n),  # flat criterion: no information
    )
    assert len(cands) == 1
    vec = weights_for_policy(cands[0])  # validates shape/dtype/finiteness
    assert vec[SC_COST] > 0, "dispersed cost must earn weight"


def test_gavel_candidates_inert_without_labels():
    assert (
        cand_gen.gavel_candidates(
            np.zeros(4), np.zeros(4), np.full(4, -1), np.ones(4, bool)
        )
        == []
    )
    got = cand_gen.gavel_candidates(
        np.array([100.0, 900.0]),
        np.zeros(2),
        np.array([0.0, 1.0]),
        np.ones(2, bool),
    )
    assert len(got) == 1 and weights_for_policy(got[0])[SC_COST] > 0


# -- outcome scoring ----------------------------------------------------------


def _fake_ov(n=4, p=4, r=2, free=4, cost=None):
    return OverlaySnapshot(
        snap=None,
        batch=None,
        pod_valid=np.ones(p, bool),
        req=np.ones((p, r), np.int64),
        row_names=[f"n{i}" for i in range(n)],
        v_cap=8,
        node_valid=np.ones(n, bool),
        free0=np.full((n, r), free, np.int64),
        alloc=np.full((n, r), free, np.int64),
        cost_milli=(
            np.zeros(n, np.int64) if cost is None else np.asarray(cost)
        ),
        energy_milli=np.zeros(n, np.int64),
        accel_class=np.full(n, -1, np.int64),
    )


def test_score_assignment_placed_fraction_dominates():
    ov = _fake_ov()
    all_placed = score_assignment(ov, np.array([0, 0, 1, 1]))
    none_placed = score_assignment(ov, np.full(4, -1))
    assert all_placed.placed == 4 and none_placed.placed == 0
    assert all_placed.utility > none_placed.utility
    assert none_placed.preempt_pressure == 4


def test_score_assignment_fragmentation_prefers_packing():
    ov = _fake_ov(n=4, p=4)
    packed = score_assignment(ov, np.array([0, 0, 0, 0]))
    smeared = score_assignment(ov, np.array([0, 1, 2, 3]))
    assert packed.fragmentation < smeared.fragmentation
    assert packed.utility > smeared.utility


def test_score_assignment_cost_norm_prefers_cheap_nodes():
    ov = _fake_ov(cost=[100, 100, 4000, 4000])
    cheap = score_assignment(ov, np.array([0, 0, 1, 1]))
    pricey = score_assignment(ov, np.array([2, 2, 3, 3]))
    assert cheap.cost_norm < pricey.cost_norm
    assert cheap.utility > pricey.utility


def test_divergence():
    ov = _fake_ov()
    prod = np.array([0, 1, 2, 3])
    assert divergence(ov, prod.copy(), prod) == 0.0
    assert divergence(ov, np.array([0, 1, 2, 0]), prod) == pytest.approx(
        0.25
    )


# -- the wave ring ------------------------------------------------------------


def test_wave_ring_bounded_with_monotonic_seq():
    ring = WaveRingBuffer(capacity=3)
    for i in range(5):
        ring.record_wave([object()], DEFAULT_WEIGHTS, [f"n{i}"])
    assert len(ring) == 3
    recs = ring.snapshot()
    assert [r.seq for r in recs] == [3, 4, 5]
    assert ring.last_seq() == 5
    assert [r.seq for r in ring.snapshot(min_seq=4)] == [5]
    assert [r.seq for r in ring.snapshot(limit=1)] == [5]
    ring.record_wave([], DEFAULT_WEIGHTS, [])  # empty wave: no record
    assert ring.last_seq() == 5
    ring.clear()
    assert len(ring) == 0


# -- ScorePolicy persistence / adoption (satellite 2's unit tier) -------------


def test_persist_and_read_roundtrip():
    server = APIServer()
    vec = DEFAULT_WEIGHTS.copy()
    vec[SC_COST] = 33.0
    assert persist_active_policy(server, "t-persist", vec, "sched-a")
    obj = server.get("scorepolicies", "", ACTIVE_POLICY_NAME)
    assert isinstance(obj, ScorePolicy)
    assert obj.policy_name == "t-persist" and obj.promotions == 1
    # second promotion UPDATES the singleton, bumping the counter
    assert persist_active_policy(server, "t-persist2", vec, "sched-b")
    obj = server.get("scorepolicies", "", ACTIVE_POLICY_NAME)
    assert obj.policy_name == "t-persist2" and obj.promotions == 2
    name, got = read_persisted_policy(server)
    assert name == "t-persist2" and np.array_equal(got, vec)


def test_adopt_persisted_policy_registers_profile():
    server = APIServer()
    vec = DEFAULT_WEIGHTS.copy()
    vec[SC_COST] = 11.0
    persist_active_policy(server, "t-adopt", vec)
    try:
        assert adopt_persisted_policy(server) == "t-adopt"
        assert np.array_equal(weights_for_policy("t-adopt"), vec)
    finally:
        WEIGHT_PROFILES.pop("t-adopt", None)


def test_adopt_absent_policy_is_none():
    assert adopt_persisted_policy(APIServer()) is None


def test_persist_degraded_store_is_counted_skip():
    server = APIServer()

    def refuse(*a, **kw):
        raise DegradedWrites("injected")

    server.guaranteed_update = refuse
    server.create = refuse
    skips0 = metrics.counter(
        "tuner_degraded_write_skips_total", {"write": "policy_persist"}
    )
    assert not persist_active_policy(server, "t-deg", DEFAULT_WEIGHTS)
    assert (
        metrics.counter(
            "tuner_degraded_write_skips_total", {"write": "policy_persist"}
        )
        == skips0 + 1
    )


def test_persisted_garbage_never_adopted():
    server = APIServer()
    server.create(
        "scorepolicies",
        ScorePolicy(
            metadata=__import__(
                "kubernetes_tpu_torch.api.objects", fromlist=["ObjectMeta"]
            ).ObjectMeta(name=ACTIVE_POLICY_NAME, namespace=""),
            weights=[float("nan")] * NUM_SCORE_COMPONENTS,
            policy_name="t-garbage",
        ),
    )
    assert read_persisted_policy(server) is None
    assert adopt_persisted_policy(server) is None
    assert "t-garbage" not in WEIGHT_PROFILES


# -- the shadow A/B gate, driven directly -------------------------------------


class _StubSched:
    """Just enough scheduler for PolicyTuner's gate methods."""

    def __init__(self):
        self._weights = DEFAULT_WEIGHTS.copy()
        self._score_policy_name = "default"
        self._ha_identity = "stub-0"
        self.swaps = []
        self.wave_recorder = None

    def set_score_policy(self, policy):
        self.swaps.append(policy)
        self._weights = weights_for_policy(policy)
        self._score_policy_name = (
            policy if isinstance(policy, str) else "custom"
        )


def _outcome(utility, placed=4, total=4):
    return WaveOutcome(
        placed=placed,
        total=total,
        fragmentation=0.0,
        preempt_pressure=total - placed,
        cost_norm=0.0,
        energy_norm=0.0,
        utility=utility,
    )


def _arm(source, name, vec, utility, chosen=None):
    if chosen is None:
        chosen = np.zeros(4, np.int64)
    return (source, name, vec, chosen, _outcome(utility))


def _mk_tuner(**kw):
    sched = _StubSched()
    server = APIServer()
    kw.setdefault("shadow_windows", 3)
    kw.setdefault("noise_floor", 0.01)
    return PolicyTuner(sched, server, **kw), sched, server


def test_gate_promotes_only_after_n_consecutive_shadow_wins():
    tuner, sched, server = _mk_tuner()
    ov = _fake_ov()
    inc = DEFAULT_WEIGHTS.copy()
    pack = WEIGHT_PROFILES["pack"].copy()
    prod_rows = np.zeros(4, np.int64)
    prod = _outcome(0.5)
    # window 1: "pack" beats the incumbent → enters shadow, NOT promoted
    tuner._decide(
        "default", inc,
        [_arm("incumbent", "default", inc, 0.5),
         _arm("profile", "pack", pack, 0.9)],
        ov, prod_rows, prod,
    )
    assert tuner._shadow is not None and tuner._shadow["wins"] == 1
    assert sched.swaps == [], "one good window must never promote"
    shadow_arms = [
        _arm("incumbent", "default", inc, 0.5),
        _arm("shadow", "pack", pack, 0.9),
    ]
    # window 2: still not enough
    tuner._decide("default", inc, shadow_arms, ov, prod_rows, prod)
    assert sched.swaps == []
    # window 3: third consecutive win → promoted, persisted, watch armed
    tuner._decide("default", inc, shadow_arms, ov, prod_rows, prod)
    assert sched.swaps == ["pack"]
    assert tuner._shadow is None and tuner._post is not None
    obj = server.get("scorepolicies", "", ACTIVE_POLICY_NAME)
    assert obj.policy_name == "pack"


def test_gate_one_lost_window_discards_challenger():
    tuner, sched, _server = _mk_tuner()
    ov = _fake_ov()
    inc = DEFAULT_WEIGHTS.copy()
    pack = WEIGHT_PROFILES["pack"].copy()
    prod_rows = np.zeros(4, np.int64)
    prod = _outcome(0.5)
    tuner._decide(
        "default", inc,
        [_arm("incumbent", "default", inc, 0.5),
         _arm("profile", "pack", pack, 0.9)],
        ov, prod_rows, prod,
    )
    assert tuner._shadow is not None
    wins0 = metrics.counter("tuner_shadow_windows_total", {"outcome": "win"})
    # the shadow DIVERGES (scores below the incumbent): discarded at once
    tuner._decide(
        "default", inc,
        [_arm("incumbent", "default", inc, 0.5),
         _arm("shadow", "pack", pack, 0.4)],
        ov, prod_rows, prod,
    )
    assert tuner._shadow is None, "a lost window must discard the shadow"
    assert sched.swaps == [], "incumbent must be kept"
    assert (
        metrics.counter("tuner_shadow_windows_total", {"outcome": "win"})
        == wins0
    )


def test_gate_rejects_nan_candidate_before_replay():
    tuner, _sched, _server = _mk_tuner()
    ov = _fake_ov()
    rejected0 = metrics.counter(
        "tuner_candidates_rejected_total", {"reason": "invalid"}
    )
    tuner.inject_candidate(
        np.full(NUM_SCORE_COMPONENTS, np.nan), name="poison"
    )
    arms = tuner._assemble_candidates("default", DEFAULT_WEIGHTS.copy(), ov)
    assert all(source != "injected" for source, _n, _v in arms)
    for _s, _n, vec in arms:
        assert np.isfinite(vec).all()
    assert (
        metrics.counter(
            "tuner_candidates_rejected_total", {"reason": "invalid"}
        )
        > rejected0
    )


def test_gate_degraded_store_pauses_promotion_keeps_shadow():
    tuner, sched, server = _mk_tuner()

    def refuse(*a, **kw):
        raise DegradedWrites("injected")

    server.guaranteed_update = refuse
    server.create = refuse
    with tuner._lock:
        tuner._shadow = {
            "name": "pack",
            "vec": WEIGHT_PROFILES["pack"].copy(),
            "wins": 3,
            "source": "profile",
        }
    tuner._promote(
        "pack", WEIGHT_PROFILES["pack"].copy(), "default",
        DEFAULT_WEIGHTS.copy(), _outcome(0.5),
    )
    assert sched.swaps == [], "a vector the store refused must not apply"
    assert tuner._shadow is not None, "shadow survives for the retry"
    assert tuner._pause_ticks > 0, "tuner pauses while degraded"
    # a paused tick is a no-op that burns one pause credit
    tuner.tick()
    assert tuner._pause_ticks == tuner.degraded_pause_ticks - 1


def test_rollback_on_post_promotion_regression():
    tuner, sched, server = _mk_tuner(rollback_windows=2)
    ov = _fake_ov()
    inc = WEIGHT_PROFILES["pack"].copy()  # "pack" was just promoted
    prod_rows = np.zeros(4, np.int64)
    with tuner._lock:
        tuner._post = {
            "prev_name": "default",
            "prev_vec": DEFAULT_WEIGHTS.copy(),
            "baseline": 0.9,
            "bad": 0,
            "good": 0,
            "seq": tuner.ring.last_seq(),
        }
    rollbacks0 = metrics.counter("tuner_rollbacks_total")
    # live waves arrive AFTER the promotion...
    tuner.ring.record_wave([object()], inc, ["n0"])
    # ...and production utility cratered vs the 0.9 baseline
    arms = [_arm("incumbent", "pack", inc, 0.3)]
    tuner._decide("pack", inc, arms, ov, prod_rows, _outcome(0.3))
    assert sched.swaps == [], "one bad window must not roll back"
    tuner._decide("pack", inc, arms, ov, prod_rows, _outcome(0.3))
    assert sched.swaps == ["default"], "regression must roll back"
    assert metrics.counter("tuner_rollbacks_total") == rollbacks0 + 1
    assert tuner._post is None
    obj = server.get("scorepolicies", "", ACTIVE_POLICY_NAME)
    assert obj.policy_name == "default", "rollback must persist too"


def test_health_lines_render():
    metrics.inc("tuner_gym_passes_total")
    lines = tuner_health_lines()
    assert any("tuner_gym_passes_total" in ln for ln in lines)


# -- (b) parity with the reference --------------------------------------------

SEED = 3


def _labelled_cluster(pkg):
    """build_cluster's nodes, bound prefill pods and pending pods in package
    `pkg`'s objects, every node given a cost label and most an energy and
    an accelerator label (the TOPSIS and Gavel arms read them)."""
    enc = importlib.import_module(f"{pkg}.ops.encoding")
    nodes, prefill, pending = build_cluster(pkg, 24, 16, 16)
    for i, n in enumerate(nodes):
        labels = n.metadata.labels
        labels[enc.LABEL_COST_PER_HOUR] = ("1.0", "2.5", "9.0")[i % 3]
        if i % 4 != 2:
            labels[enc.LABEL_ENERGY_WATTS] = str(100 + 50 * (i % 5))
        if i % 2:
            labels[enc.LABEL_ACCELERATOR_CLASS] = ("tpu-v5e", "tpu-v5p")[i % 4 // 2]
    return nodes, prefill, pending


def _caches():
    """((reference cache, pending), (port cache, pending)) over one cluster,
    each snapshot flushed to its device."""
    out = []
    for pkg, cache in zip(PACKAGES, (ref_cache(), port_cache())):
        nodes, prefill, pending = _labelled_cluster(pkg)
        for n in nodes:
            cache.add_node(n)
        for name, pod in prefill:
            pod.spec.node_name = name
            cache.add_pod(pod)
        cache.encoder.flush()
        out.append((cache, pending))
    return out


class _GymSched:
    """Just enough scheduler for a real gym pass in package `pkg`: the
    cache the overlay is taken from, the live weights and the policy
    swap."""

    def __init__(self, pkg, cache):
        self.lattice = importlib.import_module(f"{pkg}.ops.lattice")
        self.cache = cache
        self.cfg = type("Cfg", (), {"hard_pod_affinity_weight": 1.0})()
        self._weights = self.lattice.DEFAULT_WEIGHTS.copy()
        self._score_policy_name = "default"
        self._ha_identity = "gym-0"
        self.wave_recorder = None
        self.swaps = []

    def set_score_policy(self, policy):
        self.swaps.append(policy if isinstance(policy, str) else "custom")
        self._weights = self.lattice.weights_for_policy(policy)
        self._score_policy_name = (
            policy if isinstance(policy, str) else "custom"
        )


def _tick_noise(tick, p, n):
    """The reference tick's tie noise: PRNGKey(seed * 1_000_003 + tick)."""
    key = jax.random.PRNGKey(SEED * 1_000_003 + tick)
    return torch.tensor(reference_noise(key, p, n))


@pytest.fixture
def _clean_profiles():
    before = [set(importlib.import_module(f"{p}.ops.lattice").WEIGHT_PROFILES) for p in PACKAGES]
    yield
    for pkg, names in zip(PACKAGES, before):
        profiles = importlib.import_module(f"{pkg}.ops.lattice").WEIGHT_PROFILES
        for name in set(profiles) - names:
            del profiles[name]


_OV_FIELDS = (
    "pod_valid", "req", "node_valid", "free0", "alloc", "cost_milli",
    "energy_milli", "accel_class",
)


def _assert_same_overlay(ref_ov, port_ov):
    assert port_ov.row_names == ref_ov.row_names
    assert port_ov.v_cap == ref_ov.v_cap
    for f in _OV_FIELDS:
        a, b = getattr(ref_ov, f), getattr(port_ov, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)


def _outcome_fields(o):
    return (o.placed, o.total, o.fragmentation, o.preempt_pressure,
            o.cost_norm, o.energy_norm, o.utility)


def test_build_overlay_host_columns_equal_reference():
    (rc, rpods), (pc, ppods) = _caches()
    live, before = pc.encoder._device, live_tensors(pc.encoder)
    ref_ov = ref_scoring.build_overlay(rc, rpods)
    port_ov = port_scoring.build_overlay(pc, ppods)
    _assert_same_overlay(ref_ov, port_ov)
    assert port_ov.pod_valid.sum() > 0 and (port_ov.cost_milli > 0).any()
    # the overlay is a copy: no tensor shares storage with the live one
    live_ptrs = {t.untyped_storage().data_ptr() for t in live}
    for t in port_ov.snap:
        assert t.untyped_storage().data_ptr() not in live_ptrs
    assert_live_untouched(pc.encoder, live, before)


def test_arms_replays_and_scores_equal_reference():
    """Every arm the tuner assembles, replayed with the reference's noise:
    the same arms, chosen rows, outcomes, divergence and production rows;
    the live snapshot bit-identical afterwards."""
    (rc, rpods), (pc, ppods) = _caches()
    live, before = pc.encoder._device, live_tensors(pc.encoder)
    ref_ov = ref_scoring.build_overlay(rc, rpods)
    port_ov = port_scoring.build_overlay(pc, ppods)
    ref_t = ref_controller.PolicyTuner(_GymSched(REF, rc), None, seed=SEED)
    port_t = PolicyTuner(_GymSched(PORT, pc), None, seed=SEED)
    ref_arms = ref_t._assemble_candidates("default", DEFAULT_WEIGHTS.copy(), ref_ov)
    port_arms = port_t._assemble_candidates("default", DEFAULT_WEIGHTS.copy(), port_ov)
    assert [(s, n) for s, n, _v in port_arms] == [(s, n) for s, n, _v in ref_arms]
    sources = {s for s, _n, _v in port_arms}
    assert {"incumbent", "profile", "topsis", "perturb"} <= sources
    rng = np.random.default_rng(SEED)
    names = [n for n in port_ov.row_names if n is not None]
    placements = [
        "" if rng.random() < 0.2 else names[int(rng.integers(len(names)))]
        for _ in rpods
    ]
    ref_prod = ref_scoring.rows_for_placements(ref_ov, placements)
    port_prod = port_scoring.rows_for_placements(port_ov, placements)
    np.testing.assert_array_equal(port_prod, ref_prod)
    assert _outcome_fields(port_scoring.score_assignment(port_ov, port_prod)) == (
        _outcome_fields(ref_scoring.score_assignment(ref_ov, ref_prod))
    )
    key = jax.random.PRNGKey(SEED * 1_000_003 + 1)
    p, n = port_ov.req.shape[0], port_ov.node_valid.shape[0]
    noise = torch.tensor(reference_noise(key, p, n))
    for (_s, name, rvec), (_s2, _n2, pvec) in zip(ref_arms, port_arms):
        np.testing.assert_array_equal(pvec, rvec)
        ref_chosen = ref_scoring.replay_candidate(ref_ov, rvec, key, 1.0)
        port_chosen = port_scoring.replay_candidate(port_ov, pvec, noise, 1.0)
        assert port_chosen.dtype == ref_chosen.dtype
        np.testing.assert_array_equal(port_chosen, ref_chosen, err_msg=name)
        assert _outcome_fields(port_scoring.score_assignment(port_ov, port_chosen)) == (
            _outcome_fields(ref_scoring.score_assignment(ref_ov, ref_chosen))
        ), name
        assert port_scoring.divergence(port_ov, port_chosen, port_prod) == (
            ref_scoring.divergence(ref_ov, ref_chosen, ref_prod)
        )
    assert_live_untouched(pc.encoder, live, before)


def _gate_state(t):
    with t._lock:
        shadow = None if t._shadow is None else (
            t._shadow["name"], t._shadow["wins"], t._shadow["source"],
            t._shadow["vec"].tolist(),
        )
        post = None if t._post is None else (
            t._post["prev_name"], t._post["baseline"], t._post["bad"],
            t._post["good"], t._post["seq"],
        )
        return shadow, post, t._pause_ticks, t._tick_count


def test_ticks_take_the_reference_decisions(_clean_profiles):
    """Several gym passes on both packages from one injected ring and the
    reference's key chain: per tick the same arms in the same order with
    the same utilities, and the same shadow entry, promotion, persisted
    policy and (after production regresses) rollback."""
    (rc, rpods), (pc, ppods) = _caches()
    live, before = pc.encoder._device, live_tensors(pc.encoder)
    kw = dict(shadow_windows=2, noise_floor=0.005, rollback_windows=2, seed=SEED)
    ref_sched, port_sched = _GymSched(REF, rc), _GymSched(PORT, pc)
    ref_server = importlib.import_module(f"{REF}.client.apiserver").APIServer()
    port_server = APIServer()
    ref_t = ref_controller.PolicyTuner(ref_sched, ref_server, **kw)
    port_t = PolicyTuner(port_sched, port_server, noise=_tick_noise, **kw)
    seen = {}
    for name, t in (("ref", ref_t), ("port", port_t)):
        real = t._decide

        def decide(inc_name, inc_vec, scored, ov, prod_rows, prod, real=real, name=name):
            seen[name] = (
                [(s[0], s[1], np.asarray(s[2]).tolist(), s[3].tolist(),
                  _outcome_fields(s[4])) for s in scored],
                prod_rows.tolist(), _outcome_fields(prod),
            )
            return real(inc_name, inc_vec, scored, ov, prod_rows, prod)

        t._decide = decide
    names = [f"node-{i}" for i in range(24)]

    def record(placed):
        for ring, pods in ((ref_t.ring, rpods), (port_t.ring, ppods)):
            for lo in (0, 8):
                ring.record_wave(
                    pods[lo:lo + 8], DEFAULT_WEIGHTS,
                    [names[(3 * i + 1) % 23] if placed else "" for i in range(lo, lo + 8)],
                )

    record(True)
    promoted = rolled_back = False
    for tick in range(8):
        if port_sched.swaps and not rolled_back and port_t._post is not None:
            record(False)  # production regresses after the promotion
        seen.clear()
        ref_t.tick()
        port_t.tick()
        assert seen["port"] == seen["ref"], f"tick {tick + 1}: the gym passes differ"
        assert _gate_state(port_t) == _gate_state(ref_t), f"tick {tick + 1}"
        assert port_sched.swaps == ref_sched.swaps
        np.testing.assert_array_equal(port_sched._weights, ref_sched._weights)
        promoted |= bool(port_sched.swaps)
        rolled_back |= len(port_sched.swaps) >= 2
    assert promoted and rolled_back, port_sched.swaps
    persisted = [
        s.get("scorepolicies", "", ACTIVE_POLICY_NAME) for s in (ref_server, port_server)
    ]
    assert persisted[1].policy_name == persisted[0].policy_name
    # a promotion and a rollback each persist first
    assert persisted[1].promotions == persisted[0].promotions >= 2
    assert_live_untouched(pc.encoder, live, before)


# -- (c) replay of a recorded serial wave on the port's own key --------------


def test_replay_of_a_recorded_serial_wave_reproduces_production():
    """The Scheduler's default noise: the wave record keeps the Generator
    state taken before the draw (a small host tensor), and replay_wave of
    the record on a cache holding the cluster the wave launched against
    returns production's exact placements, twice."""
    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
    from kubernetes_tpu_torch.tuner.scoring import replay_wave

    def node(i):
        return v1.Node(
            metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
            status=v1.NodeStatus(allocatable={"cpu": "8", "memory": "32Gi", "pods": 110}),
        )

    server = APIServer()
    for i in range(6):
        server.create("nodes", node(i))
    sched = Scheduler(
        server,
        KubeSchedulerConfiguration(
            use_wave=False, small_batch_host_max=0, antientropy_period_s=0,
            device_batch_window=0.0,
        ),
        device="cpu", seed=11,
    )
    ring = WaveRingBuffer()
    sched.wave_recorder = ring
    try:
        sched._bringup()
        for i in range(10):
            server.create("pods", v1.Pod(
                metadata=v1.ObjectMeta(name=f"d-{i}"),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "500m"})]),
            ))
        deadline = time.monotonic() + 30
        while len(sched.queue) < 10:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        sched.schedule_pod_batch(sched.queue.pop_batch(16, timeout=0.0))
    finally:
        sched.stop()
    rec = ring.snapshot()[-1]
    assert rec.path == "serial" and len(rec.pods) == 10
    key = rec.rng_key
    assert isinstance(key, torch.Tensor) and key.dtype == torch.uint8
    assert key.device.type == "cpu" and key.numel() < 8192
    produced = dict(zip([p.metadata.name for p in rec.pods], rec.placements))
    assert all(produced.values()), produced
    # the cluster the wave launched against: the same nodes, no pods
    cache = port_cache()
    for i in range(6):
        cache.add_node(node(i))
    for _ in range(2):
        cache.encoder.flush()
        live, before = cache.encoder._device, live_tensors(cache.encoder)
        names, outcome = replay_wave(cache, rec.pods, rec.weights, rec.rng_key)
        assert dict(zip(produced, names)) == produced
        assert outcome.placed == 10
        assert_live_untouched(cache.encoder, live, before)


class _SeededSource:
    """An injected serial noise source that offers ``replay_key()``: a
    callable that redraws the source's next draw."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, p, n):
        return torch.rand((p, n), generator=self.gen)

    def replay_key(self):
        state = self.gen.get_state()

        def redraw(p, n):
            return torch.rand((p, n), generator=torch.Generator().set_state(state))

        return redraw


def test_replay_of_a_wave_drawn_by_an_injected_source():
    """An injected serial_noise with replay_key(): the record keeps its
    redraw callable, and replay_wave reproduces production from it."""
    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
    from kubernetes_tpu_torch.tuner.scoring import replay_wave

    def node(i):
        return v1.Node(
            metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
            status=v1.NodeStatus(allocatable={"cpu": "8", "memory": "32Gi", "pods": 110}),
        )

    server = APIServer()
    for i in range(5):
        server.create("nodes", node(i))
    sched = Scheduler(
        server,
        KubeSchedulerConfiguration(
            use_wave=False, small_batch_host_max=0, antientropy_period_s=0,
        ),
        device="cpu", serial_noise=_SeededSource(5),
    )
    sched.wave_recorder = ring = WaveRingBuffer()
    try:
        sched._bringup()
        for i in range(8):
            server.create("pods", v1.Pod(
                metadata=v1.ObjectMeta(name=f"s-{i}"),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "250m"})]),
            ))
        deadline = time.monotonic() + 30
        while len(sched.queue) < 8:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        sched.schedule_pod_batch(sched.queue.pop_batch(16, timeout=0.0))
    finally:
        sched.stop()
    rec = ring.snapshot()[-1]
    assert rec.path == "serial" and callable(rec.rng_key)
    cache = port_cache()
    for i in range(5):
        cache.add_node(node(i))
    names, _outcome = replay_wave(cache, rec.pods, rec.weights, rec.rng_key)
    assert names == rec.placements and all(names)


# -- (d) the harness's tuner bench on the CPU --------------------------------


def test_run_tuner_benchmark_converges_on_a_cost_aware_policy():
    """run_tuner_benchmark at the reference's defaults on the CPU: every
    burst bound, nothing promoted before the flip, a cost-aware policy
    promoted after it, the defense counters 0 (the harness raises
    otherwise)."""
    from kubernetes_tpu_torch.perf.harness import run_tuner_benchmark

    res = run_tuner_benchmark(device="cpu")
    assert res.bursts == res.bursts_bound > 0
    assert res.pre_flip_promotions == 0
    assert res.converged and res.promoted_cost_weight > 0
    assert res.promotions >= 1 and res.gym_passes >= 1
    assert res.waves_recorded >= res.pre_flip_rounds
    assert res.guard_trips == res.drift_rows == res.rebuilds == res.device_down == 0
