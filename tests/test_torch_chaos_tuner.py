"""The policy-gym chaos scenarios of tests/test_chaos_tuner.py on the port
(kubernetes_tpu_torch/, every Scheduler at device="cpu"), held to the
reference test's own assertions, with the port's APIServer as a ChaosStore
bind ledger (tests/test_torch_autoscaler.py):

  * the differential corpus: the gym's overlay replay of a recorded serial
    wave, with the recorded weights and the port's own noise key (the
    Scheduler Generator's state taken before its draw), reproduces
    production's placements exactly, twice, and leaves the live snapshot
    and the queue bit-identical;
  * the workload-mix flip: a cost-aware vector promotes and persists;
  * the leader killed mid-shadow: the replacement promotes exactly once;
  * a NaN candidate dies at the gate;
  * a degraded store pauses promotion until it heals.

The reference marks every scenario but the warm-up slow, and so does this
file. Tolerances: exact.
"""

import functools
import time

import numpy as np
import pytest
import torch

from test_torch_autoscaler import ChaosStore, assert_bind_invariants, wait_until

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.ops.encoding import LABEL_COST_PER_HOUR
from kubernetes_tpu_torch.ops.lattice import SC_COST, WEIGHT_PROFILES
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration
from kubernetes_tpu_torch.scheduler import Scheduler as _Scheduler
from kubernetes_tpu_torch.testing import lockgraph
from kubernetes_tpu_torch.tuner import ACTIVE_POLICY_NAME
from kubernetes_tpu_torch.tuner.controller import PolicyTuner
from kubernetes_tpu_torch.tuner.scoring import replay_wave
from kubernetes_tpu_torch.tuner.waves import WaveRingBuffer
from kubernetes_tpu_torch.utils.metrics import metrics

# every Scheduler of these scenarios runs on the CPU
Scheduler = functools.partial(_Scheduler, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def lock_order_watchdog():
    """Lock-order + Eraser watchdog over the tuner's two new named locks
    (tuner.ring, tuner.state) interleaving with the scheduler's: a cycle
    or an unprotected shared access fails the suite even when the
    interleaving happened to be benign. This is also the overlay-
    isolation teeth — the gym's replays share the encoder/cache with
    live scheduling, and any unlocked mutation they introduced would
    trip the sanitizer."""
    lockgraph.enable(eraser=True)
    yield
    try:
        lockgraph.assert_clean()
        assert lockgraph.tracked_access_count() > 0, (
            "lockset sanitizer observed no tracked-attribute accesses"
        )
    finally:
        lockgraph.disable()


@pytest.fixture(autouse=True)
def _reset_registered_profiles():
    before = set(WEIGHT_PROFILES)
    yield
    for name in set(WEIGHT_PROFILES) - before:
        del WEIGHT_PROFILES[name]


def make_node(name, cpu="8", cost=None):
    labels = {}
    if cost is not None:
        labels[LABEL_COST_PER_HOUR] = cost
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace="", labels=labels),
        status=v1.NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": 110}
        ),
    )


def make_pod(name, cpu="500m"):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )


def _cfg(**overrides):
    # the serial device path (use_wave=False, no small-batch host
    # shortcut): the ONLY production path whose kernel is re-launchable
    # by the gym with the exact recorded key — the differential corpus
    # rides it
    kw = dict(
        use_wave=False,
        small_batch_host_max=0,
        pod_initial_backoff_seconds=0.2,
        pod_max_backoff_seconds=2.0,
    )
    kw.update(overrides)
    return KubeSchedulerConfiguration(**kw)


def _bound(store, n):
    pods, _ = store.list("pods")
    return len(pods) == n and all(p.spec.node_name for p in pods)


def _requested_total(sched):
    snap = sched.cache.device_snapshot()
    return int(snap.requested.sum())


def test_warmup_compile_tuner_kernels():
    """Lint-exempt compile absorber (`warmup_compile` substring): the
    serial batch kernel shapes the scenarios replay compile here."""
    store = ChaosStore()
    for i in range(4):
        store.create("nodes", make_node(f"w{i}"))
    for i in range(6):
        store.create("pods", make_pod(f"wp-{i}"))
    sched = Scheduler(store, _cfg())
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, 6), 60)
    finally:
        sched.stop()


# -- scenario 1: the differential corpus --------------------------------------


@pytest.mark.slow
def test_replay_reproduces_production_and_never_touches_live_state():
    """Same weights + same key + same overlay state => the gym replay
    returns production's EXACT placements, deterministically; and the
    replay mutates neither the live snapshot nor the queue."""
    store = ChaosStore()
    for i in range(4):
        store.create("nodes", make_node(f"n{i}"))
    n = 6
    for i in range(n):
        store.create("pods", make_pod(f"d-{i}"))
    sched = Scheduler(store, _cfg())
    ring = WaveRingBuffer()
    sched.wave_recorder = ring
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, n), 60)
        assert wait_until(lambda: len(ring) >= 1, 10), "no wave recorded"
        rec = ring.snapshot()[0]
        assert rec.path == "serial" and rec.rng_key is not None
        # the port's key: the Generator state before the draw, on the host
        assert isinstance(rec.rng_key, torch.Tensor)
        assert rec.rng_key.dtype == torch.uint8
        assert rec.rng_key.device.type == "cpu"
        assert len(rec.pods) == len(rec.placements)
        produced = {
            p.metadata.name: node
            for p, node in zip(rec.pods, rec.placements)
        }
        assert all(produced.values()), f"unplaced pods in wave: {produced}"
        # return the cluster to the state wave 1 launched against
        # (empty): the overlay then equals the production snapshot
        for i in range(n):
            store.delete("pods", "default", f"d-{i}")
        assert wait_until(lambda: _requested_total(sched) == 0, 30), (
            "cache never drained back to the pre-wave state"
        )
        # clone the baseline: on the CPU the snapshot's tensors may be the
        # live ones
        snap0 = sched.cache.device_snapshot()
        fields = ("requested", "allocatable", "valid", "cost_milli")
        live_before = {f: getattr(snap0, f).clone() for f in fields}
        pending_before = len(sched.queue.pending_pods())

        got = replay_wave(
            sched.cache, rec.pods, rec.weights, rec.rng_key,
            hard_weight=sched.cfg.hard_pod_affinity_weight,
        )
        assert got is not None
        names1, outcome = got
        replayed = {
            p.metadata.name: node for p, node in zip(rec.pods, names1)
        }
        assert replayed == produced, (
            f"replay diverged from production: {replayed} != {produced}"
        )
        assert outcome.placed == len(rec.pods)
        # determinism: the identical replay twice
        names2, _ = replay_wave(
            sched.cache, rec.pods, rec.weights, rec.rng_key,
            hard_weight=sched.cfg.hard_pod_affinity_weight,
        )
        assert names2 == names1, "replay is not deterministic"
        # overlay isolation: live snapshot bit-identical, queue untouched
        live_after = sched.cache.device_snapshot()
        for f in fields:
            assert torch.equal(
                live_before[f], getattr(live_after, f)
            ), f"replay mutated live snapshot column {f}"
        assert len(sched.queue.pending_pods()) == pending_before
        assert_bind_invariants(store, allow_deleted=True)
    finally:
        sched.stop()


# -- scenario 2: workload-mix flip → re-convergence ---------------------------


@pytest.mark.slow
def test_cost_pressure_flip_promotes_cost_aware_policy():
    """Cost pressure appears (cost-divergent fleet): the gym's replays
    find a cost-aware vector that beats the cost-blind default, walk it
    through the shadow windows, promote it into the live scheduler, and
    persist it — re-convergence with zero restarts, zero recompiles."""
    store = ChaosStore()
    # 3 cheap + 3 expensive nodes: a cost-blind policy smears, a
    # cost-aware one fits everything into the cheap half
    for i in range(3):
        store.create("nodes", make_node(f"cheap{i}", cost="1.0"))
    for i in range(3):
        store.create("nodes", make_node(f"spendy{i}", cost="10.0"))
    n = 8
    for i in range(n):
        store.create("pods", make_pod(f"c-{i}"))
    sched = Scheduler(store, _cfg())
    tuner = PolicyTuner(
        sched, store,
        period_s=0.15,
        shadow_windows=2,
        noise_floor=0.005,
        seed=3,
    )
    promotions0 = metrics.counter("tuner_promotions_total")
    sched.start()
    tuner.start()
    try:
        assert wait_until(lambda: _bound(store, n), 60)
        assert wait_until(lambda: len(tuner.ring) >= 1, 10)
        # re-convergence: a promotion lands and the live weights grow a
        # cost component the default never had
        assert wait_until(
            lambda: metrics.counter("tuner_promotions_total") > promotions0,
            60,
        ), "tuner never promoted under cost pressure"
        assert sched._score_policy_name != "default"
        assert sched._weights[SC_COST] > 0, (
            f"promoted policy {sched._score_policy_name!r} is cost-blind: "
            f"{sched._weights}"
        )
        # the promotion persisted (the failover-adoption authority)
        obj = store.get("scorepolicies", "", ACTIVE_POLICY_NAME)
        assert obj.policy_name == sched._score_policy_name
        assert np.asarray(obj.weights, np.float32)[SC_COST] > 0
        assert_bind_invariants(store)
    finally:
        tuner.stop()
        sched.stop()
    assert sched.wave_recorder is None, "tuner.stop must detach recorder"


# -- scenario 3: kill-leader mid-shadow → no double promotion -----------------


@pytest.mark.slow
def test_kill_leader_mid_shadow_single_promotion():
    """Leader A dies while its challenger is mid-shadow (unpersisted by
    design — shadow state is process-local until the gate passes).
    Replacement B re-derives from its own replayed waves and promotes
    exactly ONCE: the persisted ledger's monotonic `promotions` count
    proves no double promotion, and B's live weights equal the persisted
    vector."""
    store = ChaosStore()
    for i in range(3):
        store.create("nodes", make_node(f"cheap{i}", cost="1.0"))
    for i in range(3):
        store.create("nodes", make_node(f"spendy{i}", cost="10.0"))
    n = 8
    for i in range(n):
        store.create("pods", make_pod(f"k-{i}"))
    gate_passages0 = metrics.counter("tuner_promotions_total")
    sched_a = Scheduler(store, _cfg())
    # shadow_windows high enough that A is still mid-shadow when killed
    tuner_a = PolicyTuner(
        sched_a, store, period_s=0.15, shadow_windows=50, seed=5
    )

    def _in_shadow(t):
        with t._lock:
            return t._shadow is not None

    sched_a.start()
    tuner_a.start()
    try:
        assert wait_until(lambda: _bound(store, n), 60)
        assert wait_until(
            lambda: _in_shadow(tuner_a), 30
        ), "challenger never entered shadow on leader A"
    finally:
        # kill A mid-shadow: thread down, nothing promoted or persisted
        tuner_a.stop()
        sched_a.stop()
    assert metrics.counter("tuner_promotions_total") == gate_passages0, (
        "leader A promoted while supposedly mid-shadow"
    )
    with pytest.raises(KeyError):
        store.get("scorepolicies", "", ACTIVE_POLICY_NAME)

    sched_b = Scheduler(store, _cfg())
    tuner_b = PolicyTuner(
        sched_b, store, period_s=0.15, shadow_windows=2,
        noise_floor=0.005, seed=6,
    )
    sched_b.start()  # promote() adoption path: nothing persisted → keep
    tuner_b.start()
    try:
        # B needs waves of its own: re-create traffic (A's pods are
        # bound; add a second burst so B's ring fills)
        for i in range(n):
            store.create("pods", make_pod(f"k2-{i}"))
        assert wait_until(lambda: len(tuner_b.ring) >= 1, 60)
        assert wait_until(
            lambda: _persisted_promotions(store) >= 1, 60
        ), "replacement leader never promoted"
        time.sleep(1.0)  # more ticks run: a ghost re-apply would land here
    finally:
        tuner_b.stop()
        sched_b.stop()
    # no double promotion: the persisted ledger's monotonic count equals
    # the gate passages this process performed — A (killed mid-shadow)
    # contributed ZERO, and no passage was applied twice
    assert _persisted_promotions(store) == (
        metrics.counter("tuner_promotions_total") - gate_passages0
    ), "persisted ledger diverges from actual gate passages"
    obj = store.get("scorepolicies", "", ACTIVE_POLICY_NAME)
    assert obj.policy_name == sched_b._score_policy_name
    assert np.allclose(
        np.asarray(obj.weights, np.float32), sched_b._weights
    ), "live weights diverge from the persisted vector"


def _persisted_promotions(store) -> int:
    try:
        return int(store.get("scorepolicies", "", ACTIVE_POLICY_NAME).promotions)
    except KeyError:
        return 0


# -- scenario 4: NaN candidate rejected at the gate ---------------------------


@pytest.mark.slow
def test_nan_candidate_rejected_at_gate_never_promoted():
    """A poisoned injected candidate must die at the gate: counted
    rejection, no kernel launch with NaN weights, no shadow entry, no
    promotion — driven through a REAL gym pass over a real overlay."""
    store = ChaosStore()
    for i in range(4):
        store.create("nodes", make_node(f"n{i}"))
    n = 6
    for i in range(n):
        store.create("pods", make_pod(f"p-{i}"))
    sched = Scheduler(store, _cfg())
    # huge noise floor: NOTHING can legitimately promote in this test,
    # so any observed promotion is the poison getting through
    tuner = PolicyTuner(sched, store, shadow_windows=2, noise_floor=1e9)
    sched.wave_recorder = tuner.ring
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, n), 60)
        assert wait_until(lambda: len(tuner.ring) >= 1, 10)
        rejected0 = metrics.counter(
            "tuner_candidates_rejected_total", {"reason": "invalid"}
        )
        from kubernetes_tpu_torch.ops.lattice import NUM_SCORE_COMPONENTS

        tuner.inject_candidate(
            np.full(NUM_SCORE_COMPONENTS, np.nan), name="poison"
        )
        tuner.tick()  # one full gym pass, synchronous
        assert (
            metrics.counter(
                "tuner_candidates_rejected_total", {"reason": "invalid"}
            )
            == rejected0 + 1
        ), "poisoned candidate was not rejected at the gate"
        assert tuner._shadow is None or tuner._shadow["name"] != "poison"
        assert "poison" not in WEIGHT_PROFILES
        with pytest.raises(KeyError):
            store.get("scorepolicies", "", ACTIVE_POLICY_NAME)
        assert np.isfinite(sched._weights).all()
    finally:
        sched.stop()


# -- scenario 5: degraded store pauses the tuner, then heals ------------------


@pytest.mark.slow
def test_degraded_store_pauses_promotion_until_heal():
    """The store refuses writes mid-promotion: the persist-first gate
    turns the promotion into a counted skip + pause (live weights and
    shadow state untouched); once the store heals, the promotion lands
    on a later tick."""
    from kubernetes_tpu_torch.runtime.consensus import DegradedWrites

    store = ChaosStore()
    for i in range(3):
        store.create("nodes", make_node(f"cheap{i}", cost="1.0"))
    for i in range(3):
        store.create("nodes", make_node(f"spendy{i}", cost="10.0"))
    n = 8
    for i in range(n):
        store.create("pods", make_pod(f"g-{i}"))
    sched = Scheduler(store, _cfg())
    tuner = PolicyTuner(
        sched, store, shadow_windows=2, noise_floor=0.005, seed=9
    )
    sched.wave_recorder = tuner.ring
    degraded = {"on": False}
    real_gu, real_create = store.guaranteed_update, store.create

    def gu(kind, *a, **kw):
        if degraded["on"] and kind == "scorepolicies":
            raise DegradedWrites("injected")
        return real_gu(kind, *a, **kw)

    def create(kind, *a, **kw):
        if degraded["on"] and kind == "scorepolicies":
            raise DegradedWrites("injected")
        return real_create(kind, *a, **kw)

    store.guaranteed_update, store.create = gu, create
    sched.start()
    try:
        assert wait_until(lambda: _bound(store, n), 60)
        assert wait_until(lambda: len(tuner.ring) >= 1, 10)
        degraded["on"] = True
        skips0 = metrics.counter(
            "tuner_degraded_write_skips_total", {"write": "policy_persist"}
        )
        # drive ticks until the gate tries (and fails) to persist
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            tuner.tick()
            if (
                metrics.counter(
                    "tuner_degraded_write_skips_total",
                    {"write": "policy_persist"},
                )
                > skips0
            ):
                break
        else:
            pytest.fail("promotion never reached the (refusing) store")
        assert sched._score_policy_name == "default", (
            "a vector the store refused must not go live"
        )
        assert tuner._pause_ticks > 0, "tuner did not pause while degraded"
        with pytest.raises(KeyError):
            store.get("scorepolicies", "", ACTIVE_POLICY_NAME)
        # heal: the kept shadow state promotes on a later tick
        degraded["on"] = False
        deadline = time.monotonic() + 60
        while (
            time.monotonic() < deadline
            and _persisted_promotions(store) == 0
        ):
            tuner.tick()
        assert _persisted_promotions(store) == 1, (
            "promotion never landed after the store healed"
        )
        assert sched._score_policy_name != "default"
    finally:
        store.guaranteed_update, store.create = real_gu, real_create
        sched.stop()
