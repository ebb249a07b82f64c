"""The port's data-plane defense on the CPU (device="cpu"), against the
reference: the snapshot auditor (scheduler/antientropy.py), the
kernel-output guard quarantine and the device-loss ride-through
(scheduler/scheduler.py, parallel/sharded.py), driven by the port's fault
injector (testing/device_faults.py).

(a) The scenarios of tests/test_chaos_device.py that need no device mesh,
    on the port: the same clusters, faults and invariants (zero acked-bind
    loss, zero double binds, zero wrong placements, zero leaked assumes).
    The reference's ChaosStore and NodeAgentPool are not ported: the
    port's APIServer with the bind ledger of ``_LedgerStore`` takes their
    place, and nodes are created as API objects. The reference's two mesh
    scenarios (``test_partial_device_loss_shrinks_mesh_and_reshards``,
    ``test_single_survivor_shrink_pins_uploads_to_survivor``) wait for the
    multi-device slice (ROADMAP queue 1 item 8). The two reference tests
    marked slow keep the mark.
(b) Parity with the reference on the same inputs, all exact:
    ``fetch_device_rows`` field by field; ``audit_once()`` reports after
    the same ``corrupt_device_rows`` (or master drift) on both encoders;
    the bindings and the defense counters by label after the same
    ``DeviceFaultInjector`` schedule, both Schedulers driven batch by
    batch at 64 nodes with the reference's tie noise (as
    tests/test_torch_scheduler.py does); and ``is_device_loss_error`` on
    every reference marker. The CUDA runtime's program-fault messages are
    not device loss in the port.
"""

import collections
import threading
import time

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
from kubernetes_tpu.parallel import sharded as ref_sharded
from kubernetes_tpu.perf.workloads import WorkloadConfig as RefWorkloadConfig
from kubernetes_tpu.perf.workloads import build_workload as ref_build_workload
from kubernetes_tpu.scheduler import scheduler as ref_sched_mod
from kubernetes_tpu.scheduler.antientropy import (
    SnapshotAntiEntropy as RefAntiEntropy,
)
from kubernetes_tpu.scheduler.config import (
    KubeSchedulerConfiguration as RefConfig,
)
from kubernetes_tpu.testing import device_faults as ref_faults
from kubernetes_tpu.utils.metrics import metrics as ref_metrics
from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.api.resources import CPU
from kubernetes_tpu_torch.api.selectors import selector_from_match_labels
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.ops.encoding import (
    RES_CPU,
    RETIRE_STALL_AFTER_S,
    SnapshotEncoder,
)
from kubernetes_tpu_torch.parallel import sharded
from kubernetes_tpu_torch.perf.harness import default_config
from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
from kubernetes_tpu_torch.scheduler.antientropy import SnapshotAntiEntropy
from kubernetes_tpu_torch.scheduler.cache.cache import SchedulerCache
from kubernetes_tpu_torch.testing import lockgraph
from kubernetes_tpu_torch.testing.device_faults import (
    DeviceFaultInjector,
    corrupt_device_rows,
)
from kubernetes_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def lock_order_watchdog():
    """The reference suite's watchdog on the port's named locks: record
    the acquisition-order graph (store / scheduler.cache /
    encoder.gen_lock) and the locksets of the tracked attributes across
    the whole module, and fail on a cycle or an unguarded access."""
    lockgraph.enable(eraser=True)
    yield
    try:
        lockgraph.assert_clean()
        assert lockgraph.edge_count() > 0, (
            "watchdog recorded no lock-order edges: the data-plane suite "
            "must exercise nested cache-lock -> gen-lock acquisitions"
        )
        assert lockgraph.tracked_access_count() > 0, (
            "lockset sanitizer observed no tracked-attribute accesses: "
            "the production classes are not instrumented"
        )
    finally:
        lockgraph.disable()


def wait_until(fn, timeout=60.0, period=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def make_pod(name, cpu="100m", labels=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels or {}),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )


def make_node(name, cpu="4", memory="32Gi", pods=110):
    """The reference kubelet's node object (make_node_object)."""
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        spec=v1.NodeSpec(),
        status=v1.NodeStatus(
            capacity={"cpu": cpu, "memory": memory, "pods": pods},
            allocatable={"cpu": cpu, "memory": memory, "pods": pods},
            conditions=[v1.NodeCondition(type=v1.NODE_READY, status="True")],
        ),
    )


def _bound_count(server):
    return server.count("pods", lambda p: bool(p.spec.node_name))


class _LedgerStore(APIServer):
    """The port's APIServer with the reference ChaosStore's bind ledger:
    ``acked_binds`` (uid -> node, every bind acknowledged to the caller)
    and ``applied_binds`` (applications per uid)."""

    def __init__(self):
        super().__init__()
        self.acked_binds = {}
        self.applied_binds = collections.defaultdict(int)

    def bind_pods(self, bindings, fence=None):
        errors = super().bind_pods(bindings, fence=fence)
        for b, err in zip(bindings, errors):
            if err is None:
                self.applied_binds[b.pod_uid] += 1
                self.acked_binds[b.pod_uid] = b.target_node
        return errors


def assert_bind_invariants(store: _LedgerStore):
    """Zero acked-bind loss + zero double-binds against the live store."""
    pods, _ = store.list("pods")
    by_uid = {p.metadata.uid: p for p in pods}
    lost = []
    for uid, node in store.acked_binds.items():
        cur = by_uid.get(uid)
        if cur is None:
            lost.append((uid, node, "pod gone"))
        elif cur.spec.node_name != node:
            lost.append((uid, node, f"bound to {cur.spec.node_name!r}"))
    assert not lost, f"acked binds lost: {lost}"
    doubles = {u: n for u, n in store.applied_binds.items() if n > 1}
    assert not doubles, f"double-applied binds: {doubles}"


def _cfg(**overrides):
    kw = dict(
        pod_initial_backoff_seconds=0.2,
        pod_max_backoff_seconds=2.0,
        antientropy_period_s=0.15,
        antientropy_sample_rows=256,
    )
    kw.update(overrides)
    return KubeSchedulerConfiguration(**kw)


def _no_oversubscription(store, cpu_capacity_m: int):
    """Zero wrong placements: no node's bound-pod cpu requests exceed its
    allocatable."""
    pods, _ = store.list("pods")
    per_node = {}
    for p in pods:
        if p.spec.node_name and p.metadata.deletion_timestamp is None:
            req = v1.compute_pod_resource_request(p).get(CPU, 0)
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + req
    over = {n: r for n, r in per_node.items() if r > cpu_capacity_m}
    assert not over, f"oversubscribed nodes (wrong placements): {over}"


def _no_leaked_assumes(sched, timeout=10.0):
    assert wait_until(
        lambda: not sched.cache.assumed_keys(), timeout
    ), f"leaked assumes: {sched.cache.assumed_keys()}"


# -- (a) scenario 1: snapshot corruption repaired, zero wrong placements ------


@pytest.mark.slow  # full fill + audit periods + negative-bind soak, as in
# the reference suite (which runs it under `make chaos`, no marker filter)
def test_snapshot_corruption_repaired_within_one_audit_period():
    """Device rows are corrupted to UNDER-report occupancy on a full
    cluster (the lie that would make the kernel overcommit). The auditor
    detects the drift within one period, repairs by targeted re-scatter in
    the same pass, and pods created after the repair cannot land on the
    lying rows — zero wrong placements."""
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"cn-{i}", cpu="2"))
    sched = Scheduler(store, _cfg(), device="cpu")
    sched.start()
    try:
        for i in range(8):
            store.create("pods", make_pod(f"fill-{i}", cpu="1"))
        assert wait_until(lambda: _bound_count(store) == 8, 30)
        assert sched.wait_for_idle(20)
        _no_leaked_assumes(sched)

        drift0 = metrics.counter(
            "snapshot_drift_rows_total", {"column": "requested"}
        )
        passes0 = metrics.counter("snapshot_audit_passes_total")
        enc = sched.cache.encoder
        with sched.cache.lock:
            rows = [r for r, nm in enumerate(enc.row_names) if nm]
            corrupt_device_rows(
                enc, rows, field="requested", mutate=np.zeros_like
            )
        assert wait_until(
            lambda: metrics.counter(
                "snapshot_drift_rows_total", {"column": "requested"}
            )
            > drift0,
            10,
        ), "auditor never detected the corrupted rows"

        def device_matches_masters():
            with sched.cache.lock:
                if enc._device is None or enc.has_pending_updates:
                    return False
                dev = enc._device.requested.cpu().numpy()
                return np.array_equal(dev, enc.m_req)

        assert wait_until(device_matches_masters, 10), (
            "device never converged back to the host masters"
        )
        for i in range(4):
            store.create("pods", make_pod(f"late-{i}", cpu="1"))
        time.sleep(1.0)
        assert _bound_count(store) == 8, "pod placed on a full node"
        _no_oversubscription(store, cpu_capacity_m=2000)
        assert_bind_invariants(store)
        assert metrics.counter("snapshot_audit_passes_total") > passes0
    finally:
        sched.stop()


# -- (a) scenarios 2/3: poisoned kernel outputs quarantine the batch ---------


@pytest.mark.parametrize(
    "kind,reason",
    [("nan", "nonfinite_score"), ("wild", "row_out_of_range")],
)
def test_poisoned_kernel_output_quarantines_batch_zero_pod_loss(kind, reason):
    """A NaN score (or an out-of-range chosen row) in the first wave's
    read-back trips the output guard: the whole batch quarantines to the
    host fallback path, the snapshot rebuilds, and every pod still binds
    exactly once — zero pod loss, zero wrong placements."""
    store = _LedgerStore()
    for i in range(6):
        store.create("nodes", make_node(f"gn-{i}"))
    n = 30
    for i in range(n):
        store.create("pods", make_pod(f"pz-{i}"))
    trips0 = metrics.counter("kernel_guard_trips_total", {"reason": reason})
    sched = Scheduler(store, _cfg(), device="cpu")
    inj = DeviceFaultInjector(
        nan_scores_on_readbacks={0} if kind == "nan" else (),
        wild_rows_on_readbacks={0} if kind == "wild" else (),
    ).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 30), (
            f"only {_bound_count(store)}/{n} bound after guard quarantine"
        )
        assert (
            metrics.counter("kernel_guard_trips_total", {"reason": reason})
            > trips0
        ), "guard never tripped on the poisoned readback"
        assert inj.injected, "injector never fired"
        _no_leaked_assumes(sched)
        _no_oversubscription(store, cpu_capacity_m=4000)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


# -- (a) scenario 4: device killed mid-wave — ride-through to host path ------


def test_device_killed_mid_wave_rides_through_to_host_path():
    """Every wave launch dies with a device-loss error (the card is gone).
    Bounded retries fail, the loss latch trips, and the scheduler degrades
    to the host path: every wave pod ends bound — no leaked assumes, zero
    pod loss."""
    store = _LedgerStore()
    for i in range(6):
        store.create("nodes", make_node(f"dn-{i}"))
    n = 24
    for i in range(n):
        store.create("pods", make_pod(f"dl-{i}"))
    sched = Scheduler(
        store,
        _cfg(device_retry_attempts=1, device_loss_disable_after=2),
        device="cpu",
    )
    inj = DeviceFaultInjector(fail_all_launches=True).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 40), (
            f"only {_bound_count(store)}/{n} bound after device loss"
        )
        assert sched._device_down, "device-down latch never tripped"
        assert metrics.gauge("scheduler_device_down") == 1.0
        assert metrics.counter(
            "scheduler_device_loss_total", {"stage": "launch"}
        ) >= 1
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


def test_transient_readback_loss_retries_and_recovers():
    """One readback dies (a transient blip); the bounded jittered retry
    gets the same results on the second attempt — no quarantine, no
    device down, everything binds through the device path."""
    store = _LedgerStore()
    for i in range(6):
        store.create("nodes", make_node(f"tn-{i}"))
    n = 20
    for i in range(n):
        store.create("pods", make_pod(f"tr-{i}"))
    r0 = metrics.counter(
        "scheduler_device_retries_total", {"stage": "readback"}
    )
    sched = Scheduler(store, _cfg(), device="cpu")
    inj = DeviceFaultInjector(fail_readbacks={0}).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 30)
        assert (
            metrics.counter(
                "scheduler_device_retries_total", {"stage": "readback"}
            )
            > r0
        ), "retry path never exercised"
        assert not sched._device_down
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


def test_serial_device_path_rides_through_device_loss():
    """use_wave=False: a device loss on the serial batch kernel gets the
    same ride-through as the wave path — classified, counted
    (`stage=serial`), retried, and the batch quarantined to the host
    path."""
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"sn-{i}"))
    n = 12
    for i in range(n):
        store.create("pods", make_pod(f"sp-{i}"))
    losses0 = metrics.counter(
        "scheduler_device_loss_total", {"stage": "serial"}
    )
    sched = Scheduler(
        store, _cfg(use_wave=False, device_retry_attempts=0), device="cpu"
    )
    inj = DeviceFaultInjector(fail_all_serials=True).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 30), (
            f"only {_bound_count(store)}/{n} bound via host fallback"
        )
        assert (
            metrics.counter(
                "scheduler_device_loss_total", {"stage": "serial"}
            )
            > losses0
        ), "serial device loss never classified/counted"
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


# -- (a) scenario 4b: trailing bulk readback dies AFTER the fast payload -----


def test_trailing_readback_loss_unwinds_assumes_zero_wrong_bindings():
    """Every wave's fast index payload lands cleanly and drives assumes,
    then the trailing bulk readback dies on every attempt (retries
    included). The pre-bind trailing gate quarantines each batch BEFORE
    its binds leave the process — assumes revert (counted), pods requeue
    — repeated trips latch the device path down, and the host path
    completes the backlog."""
    store = _LedgerStore()
    for i in range(6):
        store.create("nodes", make_node(f"tb-{i}"))
    n = 30
    for i in range(n):
        store.create("pods", make_pod(f"tw-{i}"))
    trips0 = metrics.counter(
        "kernel_guard_trips_total", {"reason": "trailing_readback_loss"}
    )
    unwound0 = metrics.counter(
        "scheduler_wave_trailing_unwound_assumes_total"
    )
    sched = Scheduler(store, _cfg(), device="cpu")
    inj = DeviceFaultInjector(
        fail_trailing_readbacks=set(range(64))
    ).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 30), (
            f"only {_bound_count(store)}/{n} bound after trailing-loss "
            "quarantine + host-path latch"
        )
        assert (
            metrics.counter(
                "kernel_guard_trips_total",
                {"reason": "trailing_readback_loss"},
            )
            > trips0
        ), "trailing readback loss never tripped the guard"
        assert (
            metrics.counter("scheduler_wave_trailing_unwound_assumes_total")
            > unwound0
        ), "no assumes were unwound by the pre-bind trailing gate"
        assert any(k == "trailing_loss" for k, _ in inj.injected)
        assert sched._device_down, (
            "repeated trailing trips must latch the device path down"
        )
        _no_leaked_assumes(sched)
        _no_oversubscription(store, cpu_capacity_m=4000)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


# -- (a) cache/encoder divergence regressions --------------------------------


def _labeled_pod(name, node=None, cpu="500m", labels=None):
    p = v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels or {"app": "web"}),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )
    if node:
        p.spec.node_name = node
    return p


def _snap_np(snap, fields):
    return {f: getattr(snap, f).cpu().numpy().copy() for f in fields}


def test_cleanup_expired_reverts_encoder_rows_to_pre_assume():
    """An expired assume must revert the DEVICE columns (sel_counts,
    resource requests), not just the host NodeInfo."""
    cache = SchedulerCache(
        ttl_seconds=0.01, encoder=SnapshotEncoder(device="cpu")
    )
    for i in range(3):
        cache.add_node(make_node(f"n{i}", cpu="8"))
    cache.encoder.register_service_predicate(
        "default", selector_from_match_labels({"app": "web"})
    )
    fields = ("requested", "nonzero_req", "sel_counts", "prio_req")
    before = _snap_np(cache.device_snapshot(), fields)
    pods = [_labeled_pod(f"a{i}") for i in range(4)]
    errs = cache.assume_pods_bulk(
        [(p, f"n{i % 3}", None, None) for i, p in enumerate(pods)]
    )
    assert errs == [None] * 4
    for p in pods:
        cache.finish_binding(p)
    assert not np.array_equal(cache.encoder.m_req, before["requested"]), (
        "assumes never reached the encoder masters"
    )
    assert cache.cleanup_expired(now=time.monotonic() + 60.0) == 4
    after = _snap_np(cache.device_snapshot(), fields)
    for field in fields:
        np.testing.assert_array_equal(
            after[field], before[field],
            err_msg=f"device {field} did not revert to pre-assume values",
        )


def test_cleanup_expired_reverts_encoder_even_when_nodeinfo_diverged():
    """Encoder removal is not gated on the NodeInfo still holding the
    pod: after a host/device divergence the expired assume's occupancy
    must not stay in the encoder."""
    cache = SchedulerCache(
        ttl_seconds=0.01, encoder=SnapshotEncoder(device="cpu")
    )
    cache.add_node(make_node("n0", cpu="8"))
    before = _snap_np(cache.device_snapshot(), ("requested",))
    pod = _labeled_pod("diverged")
    cache.assume_pod(pod, "n0")
    cache.finish_binding(pod)
    cache._nodes["n0"].remove_pod(pod.metadata.key)
    assert cache.cleanup_expired(now=time.monotonic() + 60.0) == 1
    after = _snap_np(cache.device_snapshot(), ("requested",))
    np.testing.assert_array_equal(
        after["requested"], before["requested"],
        err_msg="phantom encoder occupancy leaked past cleanup_expired",
    )


def test_bulk_fallback_encoder_failure_is_per_item_not_a_raise():
    """A non-KeyError from the per-pod encoder fallback must not propagate
    mid-wave — the failing item unwinds, gets a per-item error, and hands
    its row to the anti-entropy repairer; the rest assume normally."""
    cache = SchedulerCache(encoder=SnapshotEncoder(device="cpu"))
    for i in range(2):
        cache.add_node(make_node(f"n{i}", cpu="8"))
    enc = cache.encoder
    orig_add = enc.add_pod

    def flaky_add(node_name, pod, **kw):
        if pod.metadata.name == "victim":
            raise RuntimeError("injected: scatter wedged")
        return orig_add(node_name, pod, **kw)

    def broken_bulk(items):
        raise RuntimeError("injected: bulk scatter down")

    enc.add_pod = flaky_add
    enc.add_pods_bulk = broken_bulk
    pods = [
        _labeled_pod("ok-0"), _labeled_pod("victim"), _labeled_pod("ok-1"),
    ]
    errs = cache.assume_pods_bulk(
        [(p, f"n{i % 2}", None, None) for i, p in enumerate(pods)]
    )
    assert errs[0] is None and errs[2] is None
    assert errs[1] and "victim" in errs[1]
    key = pods[1].metadata.key
    assert not cache.has_pod(key)
    assert all(
        key not in {q.metadata.key for q in ni.pods}
        for ni in cache._nodes.values()
    )
    assert enc.suspect_rows
    enc.add_pod = orig_add
    for row in list(enc.suspect_rows):
        assert enc.verify_row_aggregates(row) == []
    assert cache.has_pod(pods[0].metadata.key)
    assert cache.has_pod(pods[2].metadata.key)


def test_audit_repairs_device_corruption_by_targeted_rescatter():
    """Pure encoder + auditor, no scheduler threads: zeroed device rows
    are detected AND re-scattered back to the master values in ONE pass,
    with no rebuild escalation."""
    enc = SnapshotEncoder(device="cpu")
    for i in range(4):
        enc.add_node(make_node(f"dc-{i}", cpu="8"))
    for i in range(8):
        enc.add_pod(f"dc-{i % 4}", _labeled_pod(f"dp-{i}"))
    enc.flush()
    rows = [r for r, nm in enumerate(enc.row_names) if nm]
    corrupt_device_rows(enc, rows, field="requested", mutate=np.zeros_like)
    aud = SnapshotAntiEntropy(enc, sample_rows=256)
    report = aud.audit_once()
    assert report["device_drift"].get("requested") == rows
    assert not report["rebuilt"], "targeted re-scatter escalated to rebuild"
    np.testing.assert_array_equal(
        enc._device.requested.cpu().numpy(), enc.m_req
    )


def test_audit_repairs_master_drift_from_pod_entries():
    """The master self-check: a drifted aggregate column is re-derived
    from the per-pod entries and re-scattered to the device in one audit
    pass."""
    enc = SnapshotEncoder(device="cpu")
    for i in range(4):
        enc.add_node(make_node(f"n{i}", cpu="8"))
    for i in range(6):
        enc.add_pod(f"n{i % 4}", _labeled_pod(f"p{i}"))
    enc.flush()
    aud = SnapshotAntiEntropy(enc, sample_rows=16)
    assert aud.audit_once()["device_drift"] == {}
    enc.m_req[1, RES_CPU] += 777  # the drift a lost remove_pod would leave
    report = aud.audit_once()
    assert any(r == 1 for r, _cols in report["master_repaired"])
    expected = sum(int(e.req[RES_CPU]) for e in enc._pods[1].values())
    assert int(enc.m_req[1, RES_CPU]) == expected
    np.testing.assert_array_equal(
        enc.flush().requested.cpu().numpy(), enc.m_req
    )


def test_oracle_guard_skips_post_launch_node_churn():
    """Informer churn between launch and commit (cordon, taint) must NOT
    trip the oracle guard; churned nodes are recognized by their
    generation moving past the batch's launch generation and skipped; the
    same infeasibility visible AT launch still trips."""
    from types import SimpleNamespace

    store = _LedgerStore()
    sched = Scheduler(store, _cfg(), device="cpu")
    node = make_node("on-0", cpu="2")
    sched.cache.add_node(node)
    pi = SimpleNamespace(pod=make_pod("op-0", cpu="1"))
    to_bind = [(pi, "on-0", 0, None)]
    launch_gen = sched.cache._ext_generation
    assert sched._guard_oracle_sample(to_bind, launch_gen) is None
    sched.cache.assume_pod(
        make_pod("sibling", cpu="500m"), "on-0", device_synced=True
    )
    skips0 = metrics.counter(
        "kernel_guard_oracle_skips_total", {"reason": "node_churn"}
    )
    assert sched._guard_oracle_sample(to_bind, launch_gen) is None
    assert (
        metrics.counter(
            "kernel_guard_oracle_skips_total", {"reason": "node_churn"}
        )
        == skips0
    ), "device-synced sibling assume must not exempt the node"
    sched.cache.assume_pod(make_pod("hostpod", cpu="1"), "on-0")
    assert sched._guard_oracle_sample(to_bind, launch_gen) is None
    assert (
        metrics.counter(
            "kernel_guard_oracle_skips_total", {"reason": "node_churn"}
        )
        > skips0
    ), "host-path assume must skip, not trip, the oracle"
    skips0 = metrics.counter(
        "kernel_guard_oracle_skips_total", {"reason": "node_churn"}
    )
    node.spec.unschedulable = True
    sched.cache.update_node(node)
    assert sched._guard_oracle_sample(to_bind, launch_gen) is None
    assert (
        metrics.counter(
            "kernel_guard_oracle_skips_total", {"reason": "node_churn"}
        )
        > skips0
    )
    assert (
        sched._guard_oracle_sample(to_bind, sched.cache._ext_generation)
        is not None
    )
    sched.stop()


def test_suspect_rows_survive_failed_audit_pass():
    """A mid-pass device error (fetch/flush raising) must not discard the
    failure-flagged suspect rows: they keep their audit-first priority for
    the next pass and are drained only after a pass completes."""
    enc = SnapshotEncoder(device="cpu")
    for i in range(4):
        enc.add_node(make_node(f"ar-{i}", cpu="8"))
    enc.add_pod("ar-0", _labeled_pod("ar-pod"))
    enc.flush()
    enc.suspect_rows.add(0)
    aud = SnapshotAntiEntropy(enc, sample_rows=4)
    orig = enc.fetch_device_rows

    def boom(rows):
        raise RuntimeError("device lost mid-fetch")

    enc.fetch_device_rows = boom
    with pytest.raises(RuntimeError):
        aud.audit_once()
    assert 0 in enc.suspect_rows, "failed pass discarded the suspect flag"
    enc.fetch_device_rows = orig
    report = aud.audit_once()
    assert report["rows_audited"] >= 1
    assert not enc.suspect_rows, "completed pass should drain the suspects"


# -- (a) generational snapshot: pinned readers vs donating writers -----------


def test_audit_gather_concurrent_with_donating_launch_on_newer_generation():
    """A reader holds a pin on generation N (the audit's row gather) while
    a donating advance lands on the newer generation: the donor pays one
    copy-on-pin and the pinned gather reads intact tensors. Then a
    threaded soak of the same shape: a fetch loop races a donating-flush
    loop with zero deadlocks and zero cross-generation reads."""
    metrics.reset()
    enc = SnapshotEncoder(device="cpu")
    host_lock = lockgraph.named_lock("scheduler.cache")
    for i in range(8):
        enc.add_node(make_node(f"gg-{i}", cpu="8"))
    enc.add_pod("gg-0", _labeled_pod("gg-pod"))
    enc.flush()
    expected_req = enc.m_req.copy()

    with enc.pin_generation() as lease:
        pinned_gen = lease.gen_id
        copies0 = metrics.counter("snapshot_generation_copy_on_pin_total")
        with host_lock:
            enc.mark_row_dirty("gg-1")
            enc.flush(donate=True)
        assert enc.device_generation > pinned_gen
        assert (
            metrics.counter("snapshot_generation_copy_on_pin_total")
            == copies0 + 1
        ), "a donating advance under a reader pin must copy, never consume"
        pinned_req = lease.snap.requested.cpu().numpy()
        assert np.array_equal(pinned_req, expected_req), (
            "pinned generation corrupted by a concurrent donation"
        )
        assert metrics.gauge("snapshot_generation_pinned_readers") == 1.0
        assert metrics.gauge("snapshot_generation_retiring") == 1.0
    assert metrics.gauge("snapshot_generation_retiring") == 0.0
    assert metrics.counter("snapshot_generation_retired_total") >= 1.0

    with host_lock:
        live = [r for r, nm in enumerate(enc.row_names) if nm]
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                fetched = enc.fetch_device_rows(live)
                if fetched is None:
                    continue
                if not np.array_equal(
                    fetched["requested"], enc.m_req[live]
                ):
                    errors.append("cross-generation read: stale rows")
                    return
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(repr(e))

    def writer():
        try:
            for i in range(60):
                with host_lock:
                    enc.mark_row_dirty(f"gg-{i % 8}")
                    enc.flush(donate=True)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(repr(e))
        finally:
            stop.set()

    tr, tw = threading.Thread(target=reader), threading.Thread(target=writer)
    tr.start()
    tw.start()
    tw.join(timeout=60.0)
    tr.join(timeout=60.0)
    assert not tw.is_alive() and not tr.is_alive(), (
        "gather vs donating flush deadlocked"
    )
    assert not errors, errors


def test_chained_shared_generations_survive_intermediate_retirement():
    """Two overlapping readers across two capacity growths: when the
    intermediate generation retires, the live one inherits the
    shared-buffer tie to the still-pinned oldest generation, so a
    donating advance copies instead of consuming the tensors the oldest
    reader gathers."""
    metrics.reset()
    enc = SnapshotEncoder(device="cpu")
    for i in range(8):
        enc.add_node(make_node(f"cs-{i}", cpu="8"))
    enc.add_pod("cs-0", _labeled_pod("cs-pod"))
    enc.flush()
    expected_req = enc.m_req.copy()

    with enc.pin_generation() as r1:
        gen_a = r1.gen_id
        enc._ensure_cap("t_cap", enc.cfg.t_cap * 2)
        enc.flush()
        with enc.pin_generation() as r2:
            assert r2.gen_id > gen_a
            enc._ensure_cap("t_cap", enc.cfg.t_cap * 2)
            enc.flush()
        live = enc._gen
        assert live.shared_parent is not None, (
            "intermediate retirement severed the shared-buffer tie while "
            "the oldest ancestor is still pinned"
        )
        assert live.shared_parent.gen_id == gen_a
        copies0 = metrics.counter("snapshot_generation_copy_on_pin_total")
        enc.mark_row_dirty("cs-1")
        enc.flush(donate=True)
        assert (
            metrics.counter("snapshot_generation_copy_on_pin_total")
            == copies0 + 1
        ), "donation on a chained-shared generation must copy, not consume"
        pinned_req = r1.snap.requested.cpu().numpy()
        assert np.array_equal(pinned_req, expected_req), (
            "reader R1's pinned tensors were donated out from under it"
        )
    assert enc._gen.shared_parent is None
    assert metrics.gauge("snapshot_generation_retiring") == 0.0
    assert not enc._retiring


def test_leaked_pin_trips_stall_watchdog_without_lease_traffic():
    """A leaked reader pin on an otherwise idle encoder trips the
    retire-stall watchdog from the periodic sweep (the audit pass), not
    only when the next pin or donation arrives."""
    metrics.reset()
    enc = SnapshotEncoder(device="cpu")
    for i in range(4):
        enc.add_node(make_node(f"lp-{i}", cpu="8"))
    enc.flush()
    leaked = enc.pin_generation().__enter__()  # never exited
    enc.mark_row_dirty("lp-0")
    enc.flush(donate=True)
    stuck = enc._retiring[0]
    stuck.superseded_at -= RETIRE_STALL_AFTER_S + 1.0
    assert metrics.counter("snapshot_generation_retire_stalls_total") == 0
    aud = SnapshotAntiEntropy(enc, quiesced=lambda: False)
    report = aud.audit_once()
    assert report["skipped"] == "pipeline busy"
    assert metrics.counter("snapshot_generation_retire_stalls_total") == 1
    enc.check_retire_stalls()
    assert metrics.counter("snapshot_generation_retire_stalls_total") == 1
    leaked.__exit__(None, None, None)
    assert metrics.gauge("snapshot_generation_retiring") == 0.0


@pytest.mark.slow  # multi-batch pipeline fill, as in the reference suite
def test_pipelined_waves_at_least_two_in_flight_with_concurrent_reads():
    """With a deep pipeline, at least TWO wave batches are in flight at
    once while an auditor-style gather loop reads pinned generations the
    whole time — zero guard trips, every pod bound exactly once, no leaked
    assumes."""
    metrics.reset()
    store = _LedgerStore()
    for i in range(8):
        store.create("nodes", make_node(f"pw-{i}", cpu="64"))
    sched = Scheduler(
        store,
        _cfg(pipeline_depth=3, device_batch_size=8, device_batch_window=0.0),
        device="cpu",
    )
    n = 96
    for i in range(n):
        store.create("pods", make_pod(f"pw-{i}", cpu="100m"))
    enc = sched.cache.encoder
    stop = threading.Event()
    reader_errors = []

    def gather_loop():
        try:
            while not stop.is_set():
                with sched.cache.lock:
                    rows = [r for r, nm in enumerate(enc.row_names) if nm]
                if rows:
                    enc.fetch_device_rows(rows)
                time.sleep(0.002)
        except Exception as e:  # pragma: no cover - failure reporting
            reader_errors.append(repr(e))

    t = threading.Thread(target=gather_loop, daemon=True)
    t.start()
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 60)
        _no_leaked_assumes(sched)
    finally:
        stop.set()
        t.join(timeout=10.0)
        sched.stop()
    assert not reader_errors, reader_errors
    inflight_max = metrics.gauge("scheduler_wave_inflight_max") or 0.0
    assert inflight_max >= 2.0, f"pipeline max in flight {inflight_max}"
    trips = [
        (name, labels, val)
        for name, labels, val in metrics.snapshot_counters(
            "kernel_guard_trips_total"
        )
        if val
    ]
    assert not trips, f"guard trips during pipelined waves: {trips}"
    assert_bind_invariants(store)
    _no_oversubscription(store, cpu_capacity_m=64000)


# -- (a) the auditor in the Scheduler under the reference's defaults ---------


def test_default_configuration_starts_the_auditor_and_binds():
    """Scheduler(server, device="cpu") with no configuration is the
    reference's defaults: the auditor starts with the scheduling loop,
    pods bind, and a pass over the settled cluster finds no drift."""
    assert default_config() == KubeSchedulerConfiguration()
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"dd-{i}"))
    sched = Scheduler(store, device="cpu")
    assert sched.cfg.antientropy_period_s > 0
    sched.start()
    try:
        assert sched._auditor is not None and sched._auditor._thread.is_alive()
        for i in range(12):
            store.create("pods", make_pod(f"dd-{i}"))
        assert wait_until(lambda: _bound_count(store) == 12, 30)
        assert sched.wait_for_idle(20)
        passes0 = metrics.counter("snapshot_audit_passes_total")
        report = sched._auditor.audit_once()
        assert report["skipped"] is None and report["rows_audited"] == 4
        assert report["device_drift"] == {} and not report["master_repaired"]
        assert not report["rebuilt"]
        assert metrics.counter("snapshot_audit_passes_total") == passes0 + 1
        assert_bind_invariants(store)
    finally:
        sched.stop()
    assert not sched._auditor._thread.is_alive()


# -- (b) parity with the reference -------------------------------------------


def _encoder_pair(n_nodes=48, n_init=40):
    """The reference's and the port's encoder over the same cluster:
    SchedulingPodAffinity's nodes and initial pods, the pods placed
    round-robin."""
    ref, port = RefEncoder(), SnapshotEncoder(device="cpu")
    nodes, init, _ = build_workload(
        WorkloadConfig("SchedulingPodAffinity", n_nodes, n_init, 1)
    )
    rnodes, rinit, _ = ref_build_workload(
        RefWorkloadConfig("SchedulingPodAffinity", n_nodes, n_init, 1)
    )
    for a, b in zip(nodes, rnodes):
        port.add_node(a)
        ref.add_node(b)
    for i, (a, b) in enumerate(zip(init, rinit)):
        port.add_pod(f"node-{(5 * i) % n_nodes}", a)
        ref.add_pod(f"node-{(5 * i) % n_nodes}", b)
    port.flush()
    ref.flush()
    return ref, port


@pytest.mark.parametrize(
    "rows", [[0], [3, 1, 40], list(range(48)), [47, 0, 0, 12]]
)
def test_fetch_device_rows_matches_reference(rows):
    ref, port = _encoder_pair()
    got, want = port.fetch_device_rows(rows), ref.fetch_device_rows(rows)
    assert list(got) == list(port.ROW_FIELDS) and set(want) == set(got)
    for field, w in want.items():
        w = np.asarray(w)
        assert got[field].dtype == w.dtype, field
        np.testing.assert_array_equal(got[field], w, err_msg=field)
    assert port.fetch_device_rows([]) is None
    assert SnapshotEncoder(device="cpu").fetch_device_rows([0]) is None


def _report_key(report):
    return (
        report["rows_audited"],
        {k: list(v) for k, v in report["device_drift"].items()},
        [(r, sorted(cols)) for r, cols in report["master_repaired"]],
        report["rebuilt"],
        report["skipped"],
    )


_CORRUPTIONS = {
    "requested_zeroed": [("requested", [0, 5, 9], np.zeros_like)],
    "valid_flipped": [("valid", [2, 3], None)],
    "two_fields": [
        ("requested", list(range(16)), None),
        ("valid", list(range(16)), None),
    ],
    "float_eterm_w": [("eterm_w", [7], lambda a: a + np.float32(0.5))],
    "allocatable_and_sel_counts": [
        ("allocatable", [1, 30], None),
        ("sel_counts", [30, 31], lambda a: a + 3),
    ],
    "master_drift": None,  # host masters drift instead of the device
}


@pytest.mark.parametrize("case", list(_CORRUPTIONS))
def test_audit_reports_match_reference(case):
    """The same corruption on both encoders gives the same audit report
    (rows audited, device drift by field, master repairs, rebuild), the
    same repaired snapshot, and a clean second pass on both."""
    ref, port = _encoder_pair()
    spec = _CORRUPTIONS[case]
    if spec is None:
        for enc in (ref, port):
            enc.m_req[4, RES_CPU] += 777
            enc.m_req[11, RES_CPU] -= 100
    else:
        for field, rows, mutate in spec:
            ref_faults.corrupt_device_rows(ref, rows, field, mutate)
            corrupt_device_rows(port, rows, field, mutate)
    ref_aud = RefAntiEntropy(ref, sample_rows=64)
    port_aud = SnapshotAntiEntropy(port, sample_rows=64)
    want, got = ref_aud.audit_once(), port_aud.audit_once()
    assert want["rows_audited"] == 48
    assert want["device_drift"] or want["master_repaired"]
    assert _report_key(got) == _report_key(want)
    for field in port.ROW_FIELDS:
        np.testing.assert_array_equal(
            getattr(port._device, field).cpu().numpy(),
            np.asarray(getattr(ref._device, field)),
            err_msg=field,
        )
        np.testing.assert_array_equal(
            getattr(port._device, field).cpu().numpy(),
            port._master_of(field), err_msg=field,
        )
    again_ref, again_port = ref_aud.audit_once(), port_aud.audit_once()
    assert _report_key(again_port) == _report_key(again_ref)
    assert again_port["device_drift"] == {} and not again_port["rebuilt"]


# the reference's and the port's fault schedules, with the config each needs
_FAULTS = {
    "nan_score": (dict(nan_scores_on_readbacks={0}), {}),
    "wild_row": (dict(wild_rows_on_readbacks={0}), {}),
    "guard_latch": (dict(wild_rows_on_readbacks={0, 1, 2}), {}),
    "launch_blip": (dict(fail_launches={0}), {}),
    "readback_blip": (dict(fail_readbacks={0}), {}),
    "device_killed": (
        dict(fail_all_launches=True),
        dict(device_retry_attempts=1, device_loss_disable_after=2),
    ),
    "trailing_loss": (dict(fail_trailing_readbacks=set(range(64))), {}),
    "serial_loss": (
        dict(fail_all_serials=True),
        dict(use_wave=False, device_retry_attempts=0),
    ),
}

_DEFENSE_SERIES = (
    "kernel_guard_trips_total",
    "scheduler_device_loss_total",
    "scheduler_device_retries_total",
    "scheduler_wave_trailing_unwound_assumes_total",
)


def _series(m):
    out = {}
    for name in _DEFENSE_SERIES:
        for _n, labels, v in m.snapshot_counters(name):
            if v:
                out[(name, tuple(sorted(labels.items())))] = v
    out["scheduler_device_down"] = m.gauge("scheduler_device_down") or 0.0
    return out


def _bound(server):
    return {
        p.metadata.name: p.spec.node_name
        for p in server.list("pods")[0]
        if p.spec.node_name
    }


def _drive_pair(ref, port, ref_server, server, batch, max_rounds=200):
    """Pop the same batch from both queues and schedule it on both, until
    both are drained; backed-off pods are flushed back by hand (no queue
    flusher threads run). The bindings must agree after every step."""
    for _ in range(max_rounds):
        ref_pis = ref.queue.pop_batch(batch, timeout=0.0)
        port_pis = port.queue.pop_batch(batch, timeout=0.0)
        assert [pi.pod.metadata.name for pi in port_pis] == [
            pi.pod.metadata.name for pi in ref_pis
        ], "the queues popped different pods"
        if ref_pis:
            ref.schedule_pod_batch(ref_pis)
            port.schedule_pod_batch(port_pis)
        elif ref._pending or port._pending:
            ref._resolve_pending()
            port._resolve_pending()
        elif ref._trailing or port._trailing:
            ref._drain_trailing(block=True)
            port._drain_trailing(block=True)
        elif any(
            s.queue.pending_pods()["backoff"] for s in (ref, port)
        ):
            time.sleep(0.12)
            for s in (ref, port):
                s.queue.flush_backoff_completed()
        else:
            return
        assert len(port._pending) == len(ref._pending)
        for s in (ref, port):
            assert wait_until(lambda s=s: not s.cache.assumed_keys(), 30), (
                "the informers never confirmed every bind"
            )
        assert _bound(server) == _bound(ref_server)
    raise AssertionError("the queues never drained")


@pytest.mark.parametrize("fault", list(_FAULTS))
def test_fault_outcomes_match_reference(fault):
    """The same DeviceFaultInjector schedule on the reference's Scheduler
    and the port's, driven batch by batch at 64 nodes with the
    reference's tie noise: the same injections, the same bindings after
    every step, and the same defense counters by label (guard trips by
    reason, device losses and retries by stage, unwound assumes, the
    device-down latch)."""
    from test_torch_scheduler import _parity_servers
    from test_torch_serial_lattice import reference_noise

    inj_kw, cfg_kw = _FAULTS[fault]
    metrics.reset()
    ref_metrics.reset()
    (ref_server, ref_pods), (server, pods), n_init = _parity_servers(
        "SchedulingPodAffinity"
    )
    common = dict(
        device_batch_size=16, wave_m_cand=16, pipeline_depth=2,
        antientropy_period_s=0, use_mesh=False, device_batch_window=0.0,
        pod_initial_backoff_seconds=0.05, pod_max_backoff_seconds=0.1,
    )
    common.update(cfg_kw)
    ref = ref_sched_mod.Scheduler(ref_server, RefConfig(**common))
    keys = collections.deque()

    def wave_noise(p, m_c):
        return torch.tensor(
            np.asarray(jax.random.uniform(keys.popleft(), (p, m_c), maxval=0.999))
        )

    def serial_noise(p, n):
        key, rp, rn = keys.popleft()
        assert (rp, rn) == (p, n)
        return torch.tensor(reference_noise(key, p, n))

    port = Scheduler(
        server, KubeSchedulerConfiguration(**common), device="cpu",
        noise=wave_noise, serial_noise=serial_noise,
    )
    ref_inj = ref_faults.DeviceFaultInjector(**inj_kw).install(ref)
    port_inj = DeviceFaultInjector(**inj_kw).install(port)
    # outermost on the reference: record every launch attempt's key,
    # failed attempts included (the port draws noise for each attempt)
    launch, serial = ref._launch_wave_kernel, ref._run_serial_kernel

    def launch_rec(kern, snap, batch, ptab, weights, key):
        keys.append(key)
        return launch(kern, snap, batch, ptab, weights, key)

    def serial_rec(kern, snap, batch, key, weights=None):
        keys.append((key, batch.valid.shape[0], snap.valid.shape[0]))
        return serial(kern, snap, batch, key, weights)

    ref._launch_wave_kernel = launch_rec
    ref._run_serial_kernel = serial_rec
    try:
        for s in (ref, port):
            s._bringup()
        for s, srv, ps in ((ref, ref_server, ref_pods), (port, server, pods)):
            for p in ps:
                srv.create("pods", p)
            assert wait_until(
                lambda s=s, ps=ps: len(s.queue) == len(ps)
                and s.cache.pod_count() == n_init,
                30,
            ), "the informers never queued every pod"
        _drive_pair(ref, port, ref_server, server, 16)
        assert not keys, "the port drew less noise than the reference"
        assert port_inj.injected == ref_inj.injected
        assert port_inj.injected, "the injector never fired"
        assert _bound(server) == _bound(ref_server)
        assert len(_bound(server)) == len(pods) + n_init
        assert _series(metrics) == _series(ref_metrics)
        assert port._device_down == ref._device_down
        assert port._device_down == (
            fault in ("guard_latch", "device_killed", "trailing_loss", "serial_loss")
        )
        assert not port.cache.assumed_keys()
    finally:
        ref.stop()
        port.stop()


_CUDA_PROGRAM_FAULTS = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: invalid configuration argument",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: out of memory",
    "fit_mask kernel launch failed: CUDA error 700",
    "fit_mask_least_alloc kernel launch failed: CUDA error 9",
)
_CUDA_DEVICE_LOSS = (
    "CUDA error: no CUDA-capable device is detected",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: the launch timed out and was terminated",
    "cudaErrorNoDevice",
    "cudaErrorECCUncorrectable",
)


def test_is_device_loss_error_matches_reference_and_knows_cuda():
    class XlaRuntimeError(Exception):
        pass

    for marker in ref_sharded._DEVICE_LOSS_MARKERS:
        assert marker in sharded._DEVICE_LOSS_MARKERS
        for exc in (
            RuntimeError(f"INTERNAL: {marker.upper()} while copying"),
            XlaRuntimeError(f"x {marker} y"),
            ValueError(marker),
        ):
            assert sharded.is_device_loss_error(
                exc
            ) == ref_sharded.is_device_loss_error(exc), (marker, exc)
    for exc, ref_exc in (
        (sharded.DeviceLossError("x"), ref_sharded.DeviceLossError("x")),
        (RuntimeError("kernel bug"),) * 2,
        (KeyError("device lost"),) * 2,
    ):
        assert sharded.is_device_loss_error(
            exc
        ) == ref_sharded.is_device_loss_error(ref_exc), exc
    for msg in _CUDA_PROGRAM_FAULTS:
        assert not sharded.is_device_loss_error(RuntimeError(msg)), msg
        assert not sharded.is_device_loss_error(torch.AcceleratorError(msg)), msg
    for msg in _CUDA_DEVICE_LOSS:
        assert sharded.is_device_loss_error(RuntimeError(msg)), msg
        assert sharded.is_device_loss_error(torch.AcceleratorError(msg)), msg


def test_call_with_device_retry_retries_only_device_loss():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise sharded.DeviceLossError("blip")
        return "ok"

    retries = []
    assert sharded.call_with_device_retry(
        flaky, attempts=2, base_delay_s=0.001,
        on_retry=lambda n, e: retries.append(n),
    ) == "ok"
    assert retries == [1, 2]
    calls.clear()
    with pytest.raises(sharded.DeviceLossError):
        sharded.call_with_device_retry(flaky, attempts=1, base_delay_s=0.001)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sharded.call_with_device_retry(
            lambda: (_ for _ in ()).throw(
                RuntimeError("CUDA error: an illegal memory access was encountered")
            ),
            attempts=5, base_delay_s=0.001,
        )


def test_device_probe_answers_on_the_cpu():
    from kubernetes_tpu_torch.parallel.mesh import _default_probe

    assert _default_probe(torch.device("cpu"))
    assert Scheduler._device_probe(torch.device("cpu"))
