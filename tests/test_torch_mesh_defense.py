"""The mesh rungs of the device-loss ladder in the port, on the CPU: the
two scenarios of tests/test_chaos_device.py that need a device mesh
(``test_partial_device_loss_shrinks_mesh_and_reshards`` and
``test_single_survivor_shrink_pins_uploads_to_survivor``), and the shrink
helpers of parallel/mesh.py against the reference's.

The mesh is ``virtual_devices("cpu", 8)``: eight entries with distinct ids
on one CPU device. Deaths are declared through the Scheduler's injectable
probe by entry id, as the reference's scenario declares them by jax device
id; placement is read from the mesh entry (its id), since every virtual
entry shares one ``torch.device``. The clusters, faults and invariants are
the reference's (every pod bound once, zero acknowledged-bind loss, no
leaked assume), on tests/test_torch_device_defense.py's ledger store.
"""

import jax
import pytest
import torch

from kubernetes_tpu.parallel import mesh as ref_mesh
from kubernetes_tpu_torch.ops.encoding import DeviceSnapshot, ShardedSnapshot, SnapshotEncoder
from kubernetes_tpu_torch.parallel.mesh import (
    REPLICATED_FIELDS,
    largest_pow2_prefix,
    make_mesh,
    single_device_shardings,
    snapshot_shardings,
    surviving_devices,
    virtual_devices,
)
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.testing.device_faults import DeviceFaultInjector
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_device_defense import (
    _LedgerStore,
    _bound_count,
    _cfg,
    _no_leaked_assumes,
    assert_bind_invariants,
    make_node,
    make_pod,
    wait_until,
)

ALIVE_SETS = [
    set(), {0}, {1}, {7}, {0, 1, 2, 3}, {1, 2, 3, 4, 5}, {0, 2, 4, 6, 7},
    set(range(8)),
]


@pytest.mark.parametrize("alive", ALIVE_SETS, ids=lambda a: "-".join(map(str, sorted(a))) or "none")
def test_shrink_helpers_match_the_reference(alive):
    """surviving_devices (a probe that answers False or raises counts as
    dead) and largest_pow2_prefix choose the same entries, by id, as the
    reference's on its 8 virtual devices."""

    def probe_of(ids):
        def probe(d):
            if d.id % 3 == 2 and d.id not in ids:
                raise RuntimeError("device lost")
            return d.id in ids
        return probe

    ref = ref_mesh.surviving_devices(jax.devices(), probe=probe_of(alive))
    port = surviving_devices(virtual_devices("cpu", 8), probe=probe_of(alive))
    assert [d.id for d in port] == [d.id for d in ref]
    assert [d.id for d in largest_pow2_prefix(port)] == [
        d.id for d in ref_mesh.largest_pow2_prefix(ref)
    ]


def test_snapshot_shardings_split_the_fields_as_the_reference():
    """Row-major fields shard on nodes; exactly the reference's
    replicated (P()) fields replicate."""
    ref = ref_mesh.snapshot_shardings(ref_mesh.make_mesh())
    ref_rep = {f for f in ref._fields if tuple(getattr(ref, f).spec) == ()}
    assert ref_rep == set(REPLICATED_FIELDS)
    port = snapshot_shardings(make_mesh(virtual_devices("cpu", 8)))
    assert {
        f for f in port._fields if type(getattr(port, f)).__name__ == "Replicated"
    } == ref_rep


def _mesh_scheduler(store, alive_ids, n_entries=8, **cfg):
    sched = Scheduler(
        store, _cfg(**cfg), device="cpu", mesh_devices=virtual_devices("cpu", n_entries),
    )
    # the probe is the injectable seam: entries outside alive_ids are dead
    sched._device_probe = lambda device: device is not None and device.id in alive_ids
    return sched


def test_partial_device_loss_shrinks_mesh_and_reshards():
    """Half the mesh dies: the ride-through probes survivors, shrinks the
    mesh to the largest power-of-two prefix, re-shards the snapshot, and
    the next wave schedules on the smaller mesh — zero pod loss."""
    metrics.reset()
    store = _LedgerStore()
    for i in range(6):
        store.create("nodes", make_node(f"mn-{i}"))
    n = 16
    for i in range(n):
        store.create("pods", make_pod(f"ms-{i}"))
    shrinks0 = metrics.counter("scheduler_mesh_shrinks_total")
    sched = _mesh_scheduler(store, {0, 1, 2, 3}, device_retry_attempts=0)
    inj = DeviceFaultInjector(fail_launches={0}).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 40), (
            f"only {_bound_count(store)}/{n} bound after mesh shrink"
        )
        assert metrics.counter("scheduler_device_loss_total", {"stage": "launch"}) >= 1
        assert metrics.counter("scheduler_mesh_shrinks_total") == shrinks0 + 1
        assert sched._mesh is not None
        assert [d.id for d in sched._mesh.devices] == [0, 1, 2, 3]
        assert metrics.gauge("scheduler_mesh_devices") == 4.0
        assert not sched._device_down
        snap = sched.cache.encoder._device
        assert isinstance(snap, ShardedSnapshot) and snap.n_blocks == 4
        assert [d.id for d in snap.mesh.devices] == [0, 1, 2, 3]
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


def test_single_survivor_shrink_pins_uploads_to_survivor():
    """Shrinking to ONE surviving device must pin snapshot uploads to it:
    an unsharded fallback would upload to the encoder's own device —
    which after a device loss may be exactly the dead one. Read by the
    mesh entry's id: every virtual entry shares the CPU device."""
    survivor = virtual_devices("cpu", 8)[1]
    enc = SnapshotEncoder(device="cpu")
    for i in range(4):
        enc.add_node(make_node(f"sv-{i}"))
    enc.flush()
    enc.set_sharding(*single_device_shardings(survivor))
    snap = enc.flush()  # set_sharding invalidates: full re-upload, pinned
    assert enc.pinned_device == survivor and enc.pinned_device.id == 1
    assert enc.mesh is None and isinstance(snap, DeviceSnapshot)
    for field in snap._fields:
        assert getattr(snap, field).device == survivor.device, field
    # update scatters (dirty-row path) stay pinned too
    enc.add_pod("sv-0", make_pod("sv-pod"))
    snap = enc.flush()
    assert snap.requested.device == survivor.device
    assert enc.pinned_device.id == 1
    assert int(snap.requested[0, 0]) > 0


@pytest.mark.parametrize("alive", [{1}, {0}], ids=["entry-1", "entry-0"])
def test_scheduler_shrinks_to_a_single_survivor_and_binds(alive):
    """The Scheduler's rung for one survivor: two of a 2-entry mesh, one
    dead; the mesh is dropped, the encoder pinned to the survivor (by id),
    scheduler_mesh_devices reads 1, and every pod binds once on it."""
    metrics.reset()
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"sn-{i}"))
    n = 12
    for i in range(n):
        store.create("pods", make_pod(f"ss-{i}"))
    sched = _mesh_scheduler(store, alive, n_entries=2, device_retry_attempts=0)
    inj = DeviceFaultInjector(fail_launches={0}).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 40)
        assert sched._mesh is None and not sched._device_down
        assert sched.cache.encoder.pinned_device.id == next(iter(alive))
        assert metrics.counter("scheduler_mesh_shrinks_total") == 1
        assert metrics.gauge("scheduler_mesh_devices") == 1.0
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


def test_transient_mesh_loss_keeps_the_mesh():
    """Every entry still answers the probe: a transient failure — the mesh
    stays, the snapshot re-uploads, nothing shrinks, every pod binds."""
    metrics.reset()
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"tn-{i}"))
    n = 12
    for i in range(n):
        store.create("pods", make_pod(f"ts-{i}"))
    sched = _mesh_scheduler(store, set(range(8)), device_retry_attempts=0)
    inj = DeviceFaultInjector(fail_launches={0}).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 40)
        assert metrics.counter("scheduler_device_loss_total", {"stage": "launch"}) >= 1
        assert sched._mesh is not None and sched._mesh.size == 8
        assert metrics.counter("scheduler_mesh_shrinks_total") == 0
        assert not sched._device_down
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()


def test_no_surviving_entry_latches_the_host_path():
    """Every entry fails the probe: the device path latches down and the
    host path binds every pod."""
    metrics.reset()
    store = _LedgerStore()
    for i in range(4):
        store.create("nodes", make_node(f"dn-{i}"))
    n = 12
    for i in range(n):
        store.create("pods", make_pod(f"ds-{i}"))
    sched = _mesh_scheduler(store, set(), device_retry_attempts=0)
    inj = DeviceFaultInjector(fail_launches={0}).install(sched)
    sched.start()
    try:
        assert wait_until(lambda: _bound_count(store) == n, 40)
        assert sched._device_down
        assert metrics.counter("scheduler_mesh_shrinks_total") == 0
        _no_leaked_assumes(sched)
        assert_bind_invariants(store)
    finally:
        sched.stop()
        inj.uninstall()
