"""The port's durable store (kubernetes_tpu_torch/runtime/wal.py,
replication.py, backup.py and native/walsink.cpp, copies of the
reference's) against the reference.

First, cross-package parity: the same records, made from a seed with
numpy (each object with an explicit uid and creation timestamp, which
ObjectMeta would otherwise take from a counter and the clock), go through
the reference's WriteAheadLog and the port's, with the pure-Python sink
and with the native group-commit sink. The logs and snapshots must be
byte-equal, and each package must recover the other's log to the same
resource version and objects. Then the port's APIServer, whose crash
recovery and disk-error classification import runtime/wal.py lazily
(client/apiserver.py: recover, _classify_disk_error,
_enter_disk_pressure): recovery rebuilds the reference's state, and an
append OSError becomes DiskFailed (fail-stop) or DiskPressure (ENOSPC,
with the default disk probe armed), as in the reference.

Then the reference's own tests of these modules, each section below the
reference file named in its heading with its imports pointed at the port
and every Scheduler at device="cpu": the native sink, the WAL cases of
tests/test_kubelet_and_wal.py (its kubelet cases stay with the kubelet,
tests/test_torch_kubelet_host.py holds the rest of it), the replication
cases of tests/test_replication.py that need no kubeadm (those are in
tests/test_torch_kubeadm.py), the disk chaos of tests/test_chaos_disk.py
(with its backup and restore round trips) and the consensus cases of
tests/test_consensus.py. The reference's slow marks are kept. Left out:
test_consensus.py's partition_minority case, a known flaky case of the
reference (ROADMAP queue 3). The kill-9 loop's child process and the
external checker (scripts/consistency_check.py, which recovers with the
reference's WAL) make the crash-loop cases a cross-package check too.
Tolerances: exact.
"""

import errno
import os

import numpy as np
import pytest

import kubernetes_tpu.api.objects as ref_v1
import kubernetes_tpu.api.serialization as ref_codec
import kubernetes_tpu.client.apiserver as ref_apiserver
import kubernetes_tpu.runtime.wal as ref_wal
import kubernetes_tpu_torch.api.objects as port_v1
import kubernetes_tpu_torch.api.serialization as port_codec
import kubernetes_tpu_torch.client.apiserver as port_apiserver
import kubernetes_tpu_torch.runtime.wal as port_wal
from kubernetes_tpu_torch.runtime.consensus import DiskFailed, DiskPressure

PACKAGES = {
    "ref": (ref_v1, ref_codec, ref_wal, ref_apiserver),
    "port": (port_v1, port_codec, port_wal, port_apiserver),
}


def _records(v1, seed: int, n: int = 120):
    """Batches of (rv, verb, kind, obj): pods and nodes created, pods
    bound and relabelled, some deleted; every field from the seed."""
    rng = np.random.default_rng(seed)
    out, batch, live, rv = [], [], {}, 0
    for i in range(n):
        rv += 1
        roll = rng.random()
        if roll < 0.15:
            node = v1.Node(
                metadata=v1.ObjectMeta(
                    name=f"node-{i}", namespace="", uid=f"uid-node-{seed}-{i}",
                    creation_timestamp=1_700_000_000.0 + i,
                    labels={"zone": f"z{int(rng.integers(4))}"},
                ),
                status=v1.NodeStatus(allocatable={
                    "cpu": str(int(rng.integers(2, 64))), "memory": "32Gi", "pods": 110,
                }),
            )
            node.metadata.resource_version = rv
            batch.append((rv, "create", "nodes", node))
        elif roll < 0.6 or not live:
            name = f"pod-{i}"
            pod = v1.Pod(
                metadata=v1.ObjectMeta(
                    name=name, uid=f"uid-pod-{seed}-{i}",
                    creation_timestamp=1_700_000_000.0 + i / 8,
                    labels={"app": f"a{int(rng.integers(3))}"},
                ),
                spec=v1.PodSpec(containers=[v1.Container(
                    name="c", image="img",
                    requests={"cpu": f"{int(rng.integers(1, 2000))}m"},
                )]),
            )
            pod.metadata.resource_version = rv
            live[name] = pod
            batch.append((rv, "create", "pods", pod))
        elif roll < 0.9:
            name = sorted(live)[int(rng.integers(len(live)))]
            pod = live[name]
            pod.spec.node_name = f"node-{int(rng.integers(100))}"
            pod.metadata.labels["tier"] = str(int(rng.integers(9)))
            pod.metadata.resource_version = rv
            batch.append((rv, "update", "pods", pod))
        else:
            name = sorted(live)[int(rng.integers(len(live)))]
            pod = live.pop(name)
            pod.metadata.resource_version = rv
            batch.append((rv, "delete", "pods", pod))
        if len(batch) >= int(rng.integers(1, 9)):
            out.append(batch)
            batch = []
    if batch:
        out.append(batch)
    return out


def _pod(v1, name: str, **meta):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, **meta),
        spec=v1.PodSpec(containers=[v1.Container(name="c", image="img")]),
    )


def _state(codec, rv, objects):
    """(rv, {kind: {key: encoded object}}) for comparison across packages."""
    return rv, {
        kind: {key: codec.encode(obj) for key, obj in sorted(objs.items())}
        for kind, objs in sorted(objects.items())
        if objs
    }


def _write_log(pkg: str, prefix: str, seed: int, native: bool, snapshot_at: int):
    v1, codec, wal_mod, _ = PACKAGES[pkg]
    wal = wal_mod.WriteAheadLog(prefix, fsync=False, native=native)
    assert wal.native is native, f"{pkg}: native sink {wal.native}, asked for {native}"
    objects = {}
    for i, batch in enumerate(_records(v1, seed)):
        wal.append_batch(batch)
        for _rv, verb, kind, obj in batch:
            key = obj.metadata.key
            if verb == "delete":
                objects.get(kind, {}).pop(key, None)
            else:
                objects.setdefault(kind, {})[key] = obj
        if i == snapshot_at:
            wal.write_snapshot(batch[-1][0], {k: list(d.values()) for k, d in objects.items()})
    wal.close()


def _files(prefix: str) -> dict:
    return {
        suffix: open(prefix + suffix, "rb").read()
        for suffix in (port_wal.LOG_SUFFIX, port_wal.SNAPSHOT_SUFFIX)
        if os.path.exists(prefix + suffix)
    }


@pytest.mark.parametrize("native", [False, True], ids=["python-sink", "native-sink"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_is_byte_equal_across_packages_and_each_recovers_the_other(tmp_path, seed, native):
    prefixes = {pkg: str(tmp_path / pkg / "store") for pkg in PACKAGES}
    for pkg, prefix in prefixes.items():
        os.makedirs(os.path.dirname(prefix))
        _write_log(pkg, prefix, seed, native, snapshot_at=5 + seed)
    ref_files, port_files = _files(prefixes["ref"]), _files(prefixes["port"])
    assert set(port_files) == set(ref_files) == {port_wal.LOG_SUFFIX, port_wal.SNAPSHOT_SUFFIX}
    for suffix in ref_files:
        assert port_files[suffix] == ref_files[suffix], f"{suffix} differs"
    # each package recovers both logs to the same state
    states = {}
    for reader, (_v1, codec, wal_mod, _) in PACKAGES.items():
        for writer, prefix in prefixes.items():
            states[reader, writer] = _state(codec, *wal_mod.WriteAheadLog.recover(prefix))
    first = states["ref", "ref"]
    assert first[0] > 0 and first[1].get("pods")
    for key, st in states.items():
        assert st == first, f"reader {key[0]} of the {key[1]} log"


def test_port_apiserver_recover_rebuilds_the_references_state(tmp_path):
    """client/apiserver.py's APIServer.recover imports runtime/wal.py: on
    the port it now runs, and rebuilds from the reference's log what the
    reference rebuilds."""
    prefix = str(tmp_path / "store")
    store = ref_apiserver.APIServer(wal=ref_wal.WriteAheadLog(prefix, fsync=False))
    for i in range(12):
        store.create("pods", _pod(ref_v1, f"p{i}", uid=f"u{i}", creation_timestamp=1.0 + i))
    store.create("nodes", ref_v1.Node(metadata=ref_v1.ObjectMeta(
        name="n0", namespace="", uid="un", creation_timestamp=1.0)))
    store.bind_pod(ref_v1.Binding(pod_name="p3", pod_namespace="default", target_node="n0"))
    store.delete("pods", "default", "p5")
    store._wal.close()
    ref = ref_apiserver.APIServer.recover(prefix)
    port = port_apiserver.APIServer.recover(prefix)
    assert port.resource_version == ref.resource_version == store.resource_version
    for kind in ("pods", "nodes"):
        a = [ref_codec.encode(o) for o in ref.list(kind)[0]]
        b = [port_codec.encode(o) for o in port.list(kind)[0]]
        assert a == b and a
    assert port.get("pods", "default", "p3").spec.node_name == "n0"
    # the recovered port store takes writes into the same log
    port.create("pods", _pod(port_v1, "after"))
    assert port_wal.WriteAheadLog.recover(prefix)[0] == store.resource_version + 1


class _FailingSink:
    """Makes every append of a Python-sink WAL raise OSError(err)."""

    def __init__(self, err: int):
        self.err = err

    def __call__(self, data):
        raise OSError(self.err, os.strerror(self.err))


@pytest.mark.parametrize("err,raised,gate", [
    (errno.EIO, "DiskFailed", "disk_failed"),
    (errno.ENOSPC, "DiskPressure", "disk_pressure"),
])
def test_wal_append_oserror_classifies_as_the_reference_does(tmp_path, err, raised, gate):
    """_classify_disk_error and _enter_disk_pressure import runtime/wal.py:
    an append OSError must surface as the reference's DegradedWrites
    subclass with the same write gate, and ENOSPC must arm the default
    disk probe over the WAL's volume."""
    outcome = {}
    for pkg, (v1, _codec, wal_mod, apiserver) in PACKAGES.items():
        wal = wal_mod.WriteAheadLog(str(tmp_path / pkg), fsync=False, native=False)
        store = apiserver.APIServer(wal=wal)
        store.create("pods", _pod(v1, "before"))
        wal._sink_write = _FailingSink(err)
        with pytest.raises(Exception) as info:
            store.create("pods", _pod(v1, "doomed"))
        outcome[pkg] = (
            type(info.value).__name__,
            store.write_gate.disk_failed,
            store.write_gate.disk_pressure,
            type(store.disk_probe).__name__ if store.disk_probe is not None else None,
            sorted(p.metadata.name for p in store.list("pods")[0]),
        )
        if pkg == "port":
            assert isinstance(info.value, {"DiskFailed": DiskFailed, "DiskPressure": DiskPressure}[raised])
            assert getattr(store.write_gate, gate)
            if err == errno.ENOSPC:
                assert isinstance(store.disk_probe, port_wal.DiskSpaceProbe)
    assert outcome["port"] == outcome["ref"]
    assert outcome["port"][0] == raised


# -- tests/test_native_walsink.py --------------------------------------
# Native group-commit WAL sink (kubernetes_tpu/native/walsink.cpp).
#
# The reference's durability layer (etcd) group-commits raft appends — many
# proposals, one fsync. These tests pin: correctness of the native path
# (records recoverable, compaction rotation survives), the group-commit win
# (a bulk bind's N records cost far fewer than N fsyncs), and the pure
# Python fallback staying equivalent.
import os
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.native import load_walsink
from kubernetes_tpu_torch.runtime.wal import WriteAheadLog


def make_pod_native(name):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
    )


def test_native_sink_builds_and_roundtrips(tmp_path):
    if load_walsink() is None:
        pytest.skip("no native toolchain")
    path = str(tmp_path / "n")
    wal = WriteAheadLog(path)
    assert wal.native, "native sink must load where g++ exists"
    server = APIServer(wal=wal)
    for i in range(50):
        server.create("pods", make_pod_native(f"p{i}"))
    wal.close()
    recovered = APIServer.recover(path)
    pods, _ = recovered.list("pods")
    assert len(pods) == 50


def test_bulk_bind_group_commits(tmp_path):
    if load_walsink() is None:
        pytest.skip("no native toolchain")
    path = str(tmp_path / "g")
    wal = WriteAheadLog(path)
    server = APIServer(wal=wal)
    n = 256
    for i in range(n):
        server.create("pods", make_pod_native(f"b{i}"))
    before = wal.fsync_count()
    bindings = [
        v1.Binding(pod_name=f"b{i}", pod_namespace="default", target_node="n0")
        for i in range(n)
    ]
    errs = server.bind_pods(bindings)
    assert all(e is None for e in errs)
    extra = wal.fsync_count() - before
    # one enqueue burst -> the committer batches; allow a little slack for
    # scheduling but require the collapse to be dramatic
    assert extra <= 8, f"{extra} fsyncs for a {n}-record bulk bind"
    wal.close()
    recovered = APIServer.recover(path)
    pods, _ = recovered.list("pods")
    assert sum(1 for p in pods if p.spec.node_name == "n0") == n


def test_compaction_rotation_with_native_sink(tmp_path):
    if load_walsink() is None:
        pytest.skip("no native toolchain")
    path = str(tmp_path / "c")
    wal = WriteAheadLog(path, compact_every=20)
    server = APIServer(wal=wal)
    for i in range(75):
        server.create("pods", make_pod_native(f"c{i}"))
    deadline = time.time() + 30
    while time.time() < deadline:
        if os.path.exists(path + ".snapshot.json"):
            break
        time.sleep(0.05)
    assert os.path.exists(path + ".snapshot.json")
    # appends after rotation still land
    server.create("pods", make_pod_native("after-rotate"))
    wal.close()
    recovered = APIServer.recover(path)
    pods, _ = recovered.list("pods")
    assert len(pods) == 76


def test_python_fallback_equivalence(tmp_path, monkeypatch):
    """Force the fallback and require identical WAL semantics."""
    import kubernetes_tpu_torch.runtime.wal as wal_mod

    monkeypatch.setattr(
        "kubernetes_tpu_torch.native.load_walsink", lambda: None
    )
    # wal.py imports load_walsink inside _open_sink via the package — patch
    # there too for safety
    path = str(tmp_path / "f")
    wal = wal_mod.WriteAheadLog(path)
    if wal.native:
        pytest.skip("monkeypatch did not take (import binding)")
    server = APIServer(wal=wal)
    for i in range(10):
        server.create("pods", make_pod_native(f"f{i}"))
    wal.close()
    recovered = APIServer.recover(path)
    pods, _ = recovered.list("pods")
    assert len(pods) == 10


# -- tests/test_kubelet_and_wal.py -------------------------------------
# Kubelet-lite node agent + durable WAL store.
#
# Covers VERDICT r1 item 7: a minimal node agent (pod sync against a fake
# runtime, status + lease heartbeats) sharing one code path between hollow
# and real nodes, plus a durable snapshot/WAL behind the API store with a
# crash-recovery test (reference fault model: crash-only against etcd,
# etcd3/store.go).
import json
import os
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.kubelet import NodeAgentPool
from kubernetes_tpu_torch.runtime.wal import WriteAheadLog
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler


def wait_until_kw(fn, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.03)
    return False


def make_pod_kw(name, cpu="100m", annotations=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, annotations=annotations or {}),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )


# ---------------------------------------------------------------------------
# kubelet
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# WAL / crash recovery
# ---------------------------------------------------------------------------


def test_wal_crash_recovery_roundtrip(tmp_path):
    path = str(tmp_path / "cluster")
    server = APIServer(wal=WriteAheadLog(path))
    server.create("nodes", v1.Node(metadata=v1.ObjectMeta(name="n0", namespace="")))
    server.create("pods", make_pod_kw("p0"))
    server.create("pods", make_pod_kw("p1"))
    server.delete("pods", "default", "p1")

    def bind(cur):
        cur.spec.node_name = "n0"
        return cur

    server.guaranteed_update("pods", "default", "p0", bind)
    rv_before = server.resource_version

    # "crash": drop the in-memory server entirely, recover from disk
    recovered = APIServer.recover(path)
    assert recovered.resource_version == rv_before
    pods, _ = recovered.list("pods")
    assert [p.metadata.name for p in pods] == ["p0"]
    assert pods[0].spec.node_name == "n0"
    nodes, _ = recovered.list("nodes")
    assert [n.metadata.name for n in nodes] == ["n0"]
    # writes continue with monotone resourceVersion
    recovered.create("pods", make_pod_kw("p2"))
    assert recovered.resource_version > rv_before


def test_wal_snapshot_compaction_and_torn_tail(tmp_path):
    path = str(tmp_path / "cluster")
    wal = WriteAheadLog(path, compact_every=10)
    server = APIServer(wal=wal)
    for i in range(25):
        server.create("pods", make_pod_kw(f"p{i}"))
    # compaction runs async off the mutation path; wait for the snapshot
    # generous timeout: fsync-per-append + async compaction under a
    # CPU-contended suite can stretch well past 10s
    assert wait_until_kw(lambda: os.path.exists(path + ".snapshot.json"), timeout=60)
    # simulate a torn final record (crash mid-append)
    with open(path + ".wal", "a", encoding="utf-8") as f:
        f.write('{"rv": 99999, "verb": "create", "kind": "pods", "obj": {tru')
    recovered = APIServer.recover(path)
    pods, _ = recovered.list("pods")
    assert len(pods) == 25  # torn record dropped, everything else intact


def test_wal_recover_races_live_compaction(tmp_path):
    """Regression: a reader whose snapshot read lands before a compaction
    publish and whose log read lands after that compaction's log rewrite
    silently lost the records in between (observed as 14/25 pods). The
    staleness re-check must compare against the LOADED snapshot's rv —
    replayed tail records can push the recovered rv past the new
    snapshot's rv and mask the stale read."""
    for trial in range(15):
        path = str(tmp_path / f"c{trial}")
        wal = WriteAheadLog(path, compact_every=10, fsync=False)
        server = APIServer(wal=wal)
        for i in range(25):
            server.create("pods", make_pod_kw(f"p{i}"))
            if i == 12:
                time.sleep(0.01)  # let the first compaction land mid-stream
        server._maybe_compact()  # second compaction races the recover below
        recovered = APIServer.recover(path)
        pods, _ = recovered.list("pods")
        assert len(pods) == 25, f"trial {trial}: lost {25 - len(pods)} records"
        t0 = time.time()
        while server._compacting.is_set() and time.time() - t0 < 10:
            time.sleep(0.005)
        wal.close()


def test_wal_scheduler_end_to_end_restart(tmp_path):
    """Full crash-restart: scheduler + kubelet pool against a durable store;
    after 'crash', a fresh control plane on the recovered store sees the
    bound pods and schedules new ones."""
    path = str(tmp_path / "cluster")
    server = APIServer(wal=WriteAheadLog(path))
    pool = NodeAgentPool(server, housekeeping_interval=0.1)
    pool.add_node("node-0")
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    pool.start()
    sched.start()
    try:
        server.create("pods", make_pod_kw("before-crash"))
        assert wait_until_kw(
            lambda: server.get("pods", "default", "before-crash").status.phase
            == "Running"
        )
    finally:
        sched.stop()
        pool.stop()

    # crash + recover
    server2 = APIServer.recover(path)
    pod = server2.get("pods", "default", "before-crash")
    assert pod.spec.node_name == "node-0"
    pool2 = NodeAgentPool(server2, housekeeping_interval=0.1)
    pool2.add_node("node-0", register=False)  # node object survived the crash
    sched2 = Scheduler(server2, KubeSchedulerConfiguration(), device="cpu")
    pool2.start()
    sched2.start()
    try:
        server2.create("pods", make_pod_kw("after-crash"))
        assert wait_until_kw(
            lambda: server2.get("pods", "default", "after-crash").status.phase
            == "Running"
        )
        # the recovered scheduler accounted the pre-crash pod: node-0 has 2
        assert (
            server2.get("pods", "default", "after-crash").spec.node_name
            == "node-0"
        )
    finally:
        sched2.stop()
        pool2.stop()


# ---------------------------------------------------------------------------
# probes (pkg/kubelet/prober)
# ---------------------------------------------------------------------------


def _probe_pod(name, annotations, readiness=None, liveness=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, annotations=annotations),
        spec=v1.PodSpec(
            containers=[
                v1.Container(
                    name="c0",
                    requests={"cpu": "100m"},
                    readiness_probe=readiness,
                    liveness_probe=liveness,
                )
            ]
        ),
    )


# -- tests/test_replication.py -----------------------------------------
# Replicated API store: sync log shipping, lease failover, term fencing
# (runtime/replication.py; reference: etcd raft behind storage.Interface,
# staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:1).
import json
import socket
import threading
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer, NotPrimary
from kubernetes_tpu_torch.runtime.replication import Follower, ReplicationListener


def _pod_repl(name, node=""):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(
            node_name=node, containers=[v1.Container(requests={"cpu": "100m"})]
        ),
    )


def _mk_pair(lease_s=0.6):
    primary = APIServer()
    listener = ReplicationListener(heartbeat_s=0.1)
    listener.attach(primary)
    follower = Follower(listener.address, lease_s=lease_s).start()
    assert follower.wait_synced(5.0)
    return primary, listener, follower


def test_follower_receives_snapshot_and_live_stream():
    primary = APIServer()
    primary.create("pods", _pod_repl("pre-existing"))
    listener = ReplicationListener(heartbeat_s=0.1)
    listener.attach(primary)
    follower = Follower(listener.address, lease_s=30.0).start()
    assert follower.wait_synced(5.0)
    assert "pre-existing" in {
        k.split("/")[-1] for k in follower.objects.get("pods", {})
    }
    primary.create("pods", _pod_repl("live"))
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if any(k.endswith("/live") for k in follower.objects.get("pods", {})):
            break
        time.sleep(0.01)
    else:
        pytest.fail("live record never replicated")
    listener.close()
    follower.stop()


def test_chaos_kill_primary_mid_burst_no_acked_write_lost():
    """The VERDICT r3 'done' bar: kill the primary mid-burst, the follower
    promotes, and every write the client saw acknowledged is present on
    the promoted server."""
    primary, listener, follower = _mk_pair(lease_s=0.5)
    acked = []
    dead = threading.Event()

    def writer():
        i = 0
        while not dead.is_set() and i < 500:
            name = f"burst-{i}"
            try:
                primary.create("pods", _pod_repl(name))
            except Exception:
                break  # primary died mid-call: write was NOT acknowledged
            acked.append(name)
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    # kill mid-burst, but only once the burst is real: a fixed sleep
    # under-shoots on a loaded machine (writes pace at follower-ack speed)
    deadline = time.monotonic() + 10.0
    while len(acked) < 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(acked) >= 20, "burst never got going"
    listener.close()  # kill -9 the primary's replication + service
    dead.set()
    t.join()

    # lease lapses -> promotion (automatic via the monitor thread)
    deadline = time.monotonic() + 5.0
    while follower.promoted is None and time.monotonic() < deadline:
        time.sleep(0.02)
    promoted = follower.promoted
    assert promoted is not None, "follower never promoted"
    have = set(promoted._objects.get("pods", {}))
    missing = [n for n in acked if f"default/{n}" not in have]
    assert not missing, f"acknowledged writes lost: {missing[:5]}…"


def test_higher_term_fences_old_primary():
    primary, listener, follower = _mk_pair(lease_s=30.0)
    # a successor (term 2) introduces itself: the old primary must fence
    sock = socket.create_connection(listener.address, timeout=5.0)
    f = sock.makefile("rwb")
    f.write((json.dumps({"hello": {"rv": 0, "term": 2}}) + "\n").encode())
    f.flush()
    resp = json.loads(f.readline())
    assert resp == {"fence": 2}
    deadline = time.monotonic() + 2.0
    while not primary.read_only and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(NotPrimary):
        primary.create("pods", _pod_repl("rejected"))
    sock.close()
    listener.close()
    follower.stop()


def test_promoted_server_serves_scheduler_relist_and_converges():
    """After failover the scheduler re-lists against the promoted server
    and schedules new work (SURVEY §5 failure recovery)."""
    primary, listener, follower = _mk_pair(lease_s=30.0)
    for i in range(3):
        primary.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
                status=v1.NodeStatus(
                    capacity={"cpu": "4", "memory": "8Gi", "pods": "110"}
                ),
            ),
        )
    primary.create("pods", _pod_repl("before-failover"))
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and follower.rv < primary._rv:
        time.sleep(0.01)
    listener.close()
    promoted = follower.promote()
    assert promoted._rv == follower.rv

    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler.config import KubeSchedulerConfiguration

    sched = Scheduler(promoted, KubeSchedulerConfiguration(use_mesh=False), device="cpu")
    sched.start()
    try:
        promoted.create("pods", _pod_repl("after-failover"))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            scheduled = promoted.count(
                "pods", lambda p: bool(p.spec.node_name)
            )
            if scheduled >= 2:
                break
            time.sleep(0.05)
        else:
            pytest.fail("scheduler did not converge on the promoted server")
    finally:
        sched.stop()
        follower.stop()


def test_replication_survives_follower_death():
    """A dead follower must not stall the primary's write path (it is
    dropped after ack_timeout, etcd-style ejection from the critical path)."""
    primary = APIServer()
    listener = ReplicationListener(heartbeat_s=0.1, ack_timeout_s=0.3)
    listener.attach(primary)
    follower = Follower(listener.address, lease_s=30.0).start()
    assert follower.wait_synced(5.0)
    follower.stop()  # stops acking (socket stays half-open briefly)
    t0 = time.monotonic()
    for i in range(3):
        primary.create("pods", _pod_repl(f"alone-{i}"))
    assert time.monotonic() - t0 < 5.0
    assert primary.count("pods") == 3
    listener.close()


def test_follower_wal_compacts(tmp_path):
    """The replica's WAL must compact on its own cadence (the primary's
    compaction doesn't reach across the wire); recovery from the
    compacted WAL still holds the full state."""
    from kubernetes_tpu_torch.runtime.wal import WriteAheadLog

    primary = APIServer()
    listener = ReplicationListener(heartbeat_s=0.1)
    listener.attach(primary)
    wal = WriteAheadLog(
        str(tmp_path / "replica"), compact_every=50, fsync=False
    )
    follower = Follower(listener.address, lease_s=30.0, wal=wal).start()
    assert follower.wait_synced(5.0)
    for i in range(120):
        primary.create("pods", _pod_repl(f"w-{i}"))
    deadline = time.monotonic() + 10.0
    while follower.rv < primary._rv and time.monotonic() < deadline:
        time.sleep(0.02)
    assert follower.rv == primary._rv
    # compaction runs async off the tail thread: poll for the shrunken log
    deadline = time.monotonic() + 10.0
    tail_records = 10**9
    while time.monotonic() < deadline:
        with open(wal.log_path, encoding="utf-8") as f:
            tail_records = sum(1 for line in f if line.strip())
        if tail_records < 120:
            break
        time.sleep(0.05)
    assert tail_records < 120, f"follower WAL never compacted: {tail_records}"
    # and recovery from the compacted state is complete. Poll-until: the
    # async compactor may still be mid-rewrite (snapshot published, tail
    # not yet settled) when the shrunken log is first observed — a
    # one-shot recover() here read exactly that window and flaked with
    # a short pod count under suite load
    deadline = time.monotonic() + 10.0
    rv, objects = WriteAheadLog.recover(str(tmp_path / "replica"))
    while (
        rv != follower.rv or len(objects.get("pods", {})) != 120
    ) and time.monotonic() < deadline:
        time.sleep(0.05)
        rv, objects = WriteAheadLog.recover(str(tmp_path / "replica"))
    assert rv == follower.rv, f"recovered rv {rv} != follower rv {follower.rv}"
    n = len(objects.get("pods", {}))
    assert n == 120, f"recovered {n}/120 pods from the compacted WAL"
    listener.close()
    follower.stop()


# -- tests/test_chaos_disk.py ------------------------------------------
# Disk chaos: the storage medium is the last un-chaos'd fault domain.
#
# Every robustness layer above the store (leadership fencing, HA adoption,
# persist-first promotion) treats the WAL as the one component that never
# lies — these tests make the WAL earn it under the four real disk failure
# modes, with deterministic injection (testing/diskfaults.py, never
# random) and the consistency-check ledger as the done-bar:
#
#   * crash mid-append (kill -9 loops + a byte-level truncation sweep):
#     recovery is exactly the acked prefix, zero acked-write loss, zero
#     wrong binds;
#   * bit-flip mid-log: recovery refuses to serve silently-wrong state —
#     longest valid prefix + DiskCorrupt promotion bar, healed by a
#     replication resync from the leader;
#   * fsync/write failure: the sink poisons permanently (fsyncgate), the
#     store degrades to read-only with the retryable DiskFailed reason,
#     and a LEADER with a failed disk releases its lease so a healthy
#     replica promotes within retry-periods — not lease expiry;
#   * ENOSPC / low space: read-only BEFORE writes fail, nothing poisoned,
#     auto-reopen once space recovers, with the fsync-stall watchdog
#     catching the slow-dying-disk prequel.
#
# Plus the disaster-recovery end of the story: a cluster restored from an
# online backup structurally rejects every pre-restore fencing token.
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer, LeaderFenced, NotFound
from kubernetes_tpu_torch.client.leaderelection import (
    COUNTER_DISK_STEPDOWNS,
    BindFence,
    Lease,
    LeaderElectionConfig,
    LeaderElector,
)
from kubernetes_tpu_torch.runtime import backup
from kubernetes_tpu_torch.runtime.consensus import DiskFailed, DiskPressure
from kubernetes_tpu_torch.runtime.replication import Follower, ReplicationListener
from kubernetes_tpu_torch.runtime.wal import (
    COUNTER_FSYNC_STALLS,
    COUNTER_RETRIES_EXHAUSTED,
    COUNTER_TMP_SWEEPS,
    DiskSpaceProbe,
    RecoveryReport,
    SinkFailed,
    WriteAheadLog,
)
from kubernetes_tpu_torch.testing.diskfaults import (
    DiskFaultInjector,
    bit_flip_record,
    truncate_log_at,
)
from kubernetes_tpu_torch.utils.metrics import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))

import consistency_check  # noqa: E402  (scripts/ is not a package)


def wait_until_disk(fn, timeout=30.0, period=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def make_pod_disk(name, namespace="default"):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, namespace=namespace),
        spec=v1.PodSpec(containers=[v1.Container(name="c", image="img")]),
    )


def make_wal(tmp_path, name="store", **kw):
    kw.setdefault("native", False)  # python sink: the injection seam
    kw.setdefault("fsync", False)
    return WriteAheadLog(str(tmp_path / name), **kw)


def fake_probe(path, free_bytes):
    """DiskSpaceProbe with injected statvfs + an always-advancing clock
    (defeats the 1s rate limit); mutate probe.free[0] to move space."""
    free = [free_bytes]
    tick = [0.0]

    def clock():
        tick[0] += 10.0
        return tick[0]

    def statvfs(_d):
        return types.SimpleNamespace(f_bavail=free[0], f_frsize=1)

    probe = DiskSpaceProbe(path, statvfs=statvfs, clock=clock)
    probe.free = free
    return probe


# ---------------------------------------------------------------------------
# kill -9 mid-append loops (the ChaosStore/consistency-check ledger)
# ---------------------------------------------------------------------------

_KILL_LOOP_CHILD = r"""
import json, os, signal, sys, time

prefix, ack_path, cycles, repo = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
)
sys.path.insert(0, repo)
from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.runtime.wal import WriteAheadLog


def worker():
    # recover exactly like a restarting node, then append + bind forever
    # until SIGKILLed; every ack line is written only AFTER the client-
    # visible success (the consistency checker's contract)
    report = WriteAheadLog.recover_report(prefix)
    if report.corrupt:
        os._exit(7)  # a process kill must never look like media damage
    srv = APIServer(wal=WriteAheadLog(prefix, fsync=False, native=False))
    srv._rv = report.rv
    srv._objects = report.objects
    ack = open(ack_path, "a", buffering=1)
    have = {p.metadata.name: p for p in srv.list("pods", "default")[0]}
    i = 0
    while True:
        name = "p%d" % i
        pod = have.get(name)
        if pod is None:
            pod = srv.create("pods", v1.Pod(
                metadata=v1.ObjectMeta(name=name, namespace="default"),
                spec=v1.PodSpec(
                    containers=[v1.Container(name="c", image="img")]
                ),
            ))
            ack.write(json.dumps({
                "op": "create", "kind": "pods",
                "key": "default/%s" % name,
                "rv": pod.metadata.resource_version,
            }) + "\n")
        if not pod.spec.node_name:
            srv.bind_pod(v1.Binding(
                pod_name=name, pod_namespace="default",
                target_node="n%d" % (i % 4),
            ))
            bound = srv.get("pods", "default", name)
            ack.write(json.dumps({
                "op": "update", "kind": "pods",
                "key": "default/%s" % name,
                "rv": bound.metadata.resource_version,
            }) + "\n")
        i += 1


for cycle in range(cycles):
    pid = os.fork()
    if pid == 0:
        try:
            worker()
        finally:
            os._exit(9)
    time.sleep(0.12)
    os.kill(pid, signal.SIGKILL)
    os.waitpid(pid, 0)

report = WriteAheadLog.recover_report(prefix)
pods = report.objects.get("pods", {})
wrong = [
    key for key, pod in pods.items()
    if pod.spec.node_name
    and pod.spec.node_name != "n%d" % (int(pod.metadata.name[1:]) % 4)
]
print(json.dumps({
    "rv": report.rv,
    "pods": len(pods),
    "bound": sum(1 for p in pods.values() if p.spec.node_name),
    "corrupt": report.corrupt,
    "wrong_binds": wrong,
}))
"""


def _run_kill_loop(tmp_path, cycles):
    prefix = str(tmp_path / "killstore")
    ack_path = str(tmp_path / "acks.jsonl")
    child = tmp_path / "kill_child.py"
    child.write_text(_KILL_LOOP_CHILD)
    proc = subprocess.run(
        [sys.executable, str(child), prefix, ack_path, str(cycles), REPO],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=60 + 2 * cycles,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, (
        f"kill loop child failed (rc={proc.returncode}):\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # zero double/wrong binds on the recovered state
    assert summary["corrupt"] is False
    assert summary["wrong_binds"] == []
    assert summary["pods"] > cycles  # each cycle made real progress
    # zero acked-write loss, proven by the external checker against the
    # surviving WAL exactly as a restarted node would recover it
    assert consistency_check.run(ack_path, [prefix]) == 0
    return summary


def test_kill9_mid_append_recovery_loop(tmp_path):
    """A handful of kill -9-mid-append crash/recover cycles: every acked
    create and bind survives; recovery never classifies a process kill
    as media corruption (tier-1-speed variant of the 50x loop below)."""
    _run_kill_loop(tmp_path, cycles=4)


@pytest.mark.slow
def test_kill9_mid_append_recovery_loop_50x(tmp_path):
    """The acceptance bar: 50 consecutive kill -9 mid-append cycles with
    zero acked-write loss and zero double-binds on the ledger."""
    summary = _run_kill_loop(tmp_path, cycles=50)
    assert summary["bound"] >= 50


# ---------------------------------------------------------------------------
# byte-level crash points (satellite: property sweep + legacy format)
# ---------------------------------------------------------------------------

def test_every_crash_point_recovers_exactly_the_acked_prefix(tmp_path):
    """Truncate a live WAL at EVERY byte offset of the final-record
    region: recovery must equal exactly the acked prefix (records whose
    bytes fully landed), never lose an acked write, and never classify
    the torn tail as mid-log corruption."""
    prefix = str(tmp_path / "sweep")
    wal = make_wal(tmp_path, "sweep")
    acks = []  # (end_offset_of_record, ack dict)
    for i in range(8):
        rv = i + 1
        pod = make_pod_disk(f"p{i}")
        pod.metadata.resource_version = rv
        wal.append(rv, "create", "pods", pod)
        acks.append((
            os.path.getsize(wal.log_path),
            {"op": "create", "kind": "pods", "key": f"default/p{i}", "rv": rv},
        ))
    wal.close()
    size = os.path.getsize(prefix + ".wal")
    last_start = acks[-2][0]  # byte where the final record begins
    scratch = str(tmp_path / "cut")
    for cut in range(last_start, size + 1):
        shutil.copyfile(prefix + ".wal", scratch + ".wal")
        truncate_log_at(scratch + ".wal", cut)
        report = WriteAheadLog.recover_report(scratch)
        assert not report.corrupt, f"cut@{cut}: torn tail misread as corrupt"
        acked = [a for end, a in acks if end <= cut]
        want_rv = acked[-1]["rv"] if acked else 0
        # recovery must hold AT LEAST every acked record; one extra is
        # legal (a complete record whose trailing newline the crash ate
        # — durable but never acknowledged), more than one is not
        assert want_rv <= report.rv <= want_rv + 1, (
            f"cut@{cut}: recovered rv={report.rv}, acked prefix rv={want_rv}"
        )
        state = {
            "rv": report.rv,
            "commit": report.commit,
            "objects": {
                kind: {
                    key: o.metadata.resource_version for key, o in d.items()
                }
                for kind, d in report.objects.items()
            },
        }
        losses = consistency_check.check(acked, state)
        assert not losses, f"cut@{cut}: {losses}"


def test_legacy_pre_crc_wal_still_recovers(tmp_path):
    """A v1 (pre-CRC, raw-JSON-lines) log recovers unchanged, and a new
    writer appends v2 frames after it — the reader sniffs per line."""
    from kubernetes_tpu_torch.api import serialization

    prefix = str(tmp_path / "legacy")
    with open(prefix + ".wal", "w", encoding="utf-8") as f:
        for i in range(5):
            f.write(json.dumps({
                "rv": i + 1, "verb": "create", "kind": "pods",
                "obj": serialization.encode(make_pod_disk(f"old{i}")),
            }) + "\n")
    report = WriteAheadLog.recover_report(prefix)
    assert report.rv == 5 and not report.corrupt
    assert len(report.objects["pods"]) == 5

    wal = make_wal(tmp_path, "legacy")
    wal.append(6, "create", "pods", make_pod_disk("new0"))
    wal.close()
    report = WriteAheadLog.recover_report(prefix)
    assert report.rv == 6 and not report.corrupt
    names = {p.metadata.name for p in report.objects["pods"].values()}
    assert names == {"old0", "old1", "old2", "old3", "old4", "new0"}


# ---------------------------------------------------------------------------
# bit-flip mid-log: refuse-to-lie + heal-by-resync
# ---------------------------------------------------------------------------

def test_bit_flip_midlog_recovers_longest_valid_prefix(tmp_path):
    prefix = str(tmp_path / "flip")
    wal = make_wal(tmp_path, "flip")
    for i in range(10):
        wal.append(i + 1, "create", "pods", make_pod_disk(f"p{i}"))
    wal.close()
    bit_flip_record(prefix + ".wal", 3)
    report = WriteAheadLog.recover_report(prefix)
    # valid acked records exist AFTER the damage: this is mid-log
    # corruption, not a torn tail — serve the honest prefix and say so
    assert report.corrupt and report.bad_records >= 1
    assert report.rv == 3
    assert set(report.objects["pods"]) == {
        "default/p0", "default/p1", "default/p2"
    }
    # the recovered server carries the promotion bar
    srv = APIServer.recover(prefix)
    assert srv.disk_corrupt


def test_corrupt_replica_heals_via_resync_and_promotes(tmp_path):
    """DiskCorrupt bars promotion until the replication snapshot-resync
    from a healthy leader replaces the state — then the bar lifts."""
    primary = APIServer()
    for i in range(6):
        primary.create("pods", make_pod_disk(f"p{i}"))
    listener = ReplicationListener(heartbeat_s=0.1)
    listener.attach(primary)
    follower = Follower(
        listener.address,
        lease_s=30.0,
        wal=make_wal(tmp_path, "healme"),
        disk_corrupt=True,
    ).start()
    try:
        assert follower.disk_corrupt
        assert follower.promote() is None  # barred while corrupt
        assert wait_until_disk(lambda: not follower.disk_corrupt, 10), (
            "snapshot resync never lifted the DiskCorrupt bar"
        )
        promoted = follower.promote()
        assert promoted is not None
        assert len(promoted.list("pods", "default")[0]) == 6
    finally:
        follower.stop()
        listener.close()


def test_follower_own_disk_failure_bars_promotion_keeps_serving(tmp_path):
    """A follower whose OWN wal append fails fail-stops durability only:
    it keeps tailing in memory (reads/watch stay live) but is barred
    from promotion permanently."""
    primary = APIServer()
    listener = ReplicationListener(heartbeat_s=0.1)
    listener.attach(primary)
    wal = make_wal(tmp_path, "failfoll")
    inj = DiskFaultInjector(fail_writes=(0,)).install(wal)
    follower = Follower(listener.address, lease_s=30.0, wal=wal).start()
    try:
        assert wait_until_disk(follower._synced.is_set, 10)
        primary.create("pods", make_pod_disk("after-sync"))
        assert wait_until_disk(lambda: follower.disk_failed, 10), (
            "WAL append failure never flipped disk_failed"
        )
        # in-memory replication still tracked the write...
        assert wait_until_disk(
            lambda: follower.list_kind("pods")[1]
            >= primary.resource_version,
            10,
        )
        # ...but this replica can never again vouch for durability
        assert follower.promote() is None
    finally:
        inj.uninstall()
        follower.stop()
        listener.close()


# ---------------------------------------------------------------------------
# fail-stop fsync discipline (fsyncgate) + leader step-down
# ---------------------------------------------------------------------------

def test_fsync_failure_poisons_sink_and_store_fail_stops(tmp_path):
    wal = make_wal(tmp_path, "fsyncfail", fsync=True)
    srv = APIServer(wal=wal)
    srv.create("pods", make_pod_disk("before"))
    inj = DiskFaultInjector(fail_all_fsyncs=True).install(wal)
    with pytest.raises(DiskFailed):
        srv.create("pods", make_pod_disk("doomed"))
    assert wal.failed is not None  # poisoned permanently
    assert srv.write_gate.disk_failed
    assert metrics.gauge("store_disk_state") == 2.0
    # fsyncgate: the next write must 503 WITHOUT touching the sink —
    # retrying fsync on dirty pages can never prove durability
    calls = inj.write_calls
    with pytest.raises(DiskFailed):
        srv.create("pods", make_pod_disk("rejected"))
    assert inj.write_calls == calls
    # reads and the already-applied (readable, unacked-durable) state
    # keep serving: fail-stop is a durability statement, not an outage
    names = {p.metadata.name for p in srv.list("pods", "default")[0]}
    assert "before" in names and "doomed" in names
    inj.uninstall()
    # poisoning survives the injector: the sink never comes back
    with pytest.raises((DiskFailed, SinkFailed)):
        srv.create("pods", make_pod_disk("still-rejected"))


def test_leader_with_failed_disk_steps_down_within_retry_periods(tmp_path):
    """The leader releases its lease on disk death, so a disk-healthy
    standby promotes inside retry-periods — NOT after lease expiry."""
    store = APIServer()
    cfg = lambda ident: LeaderElectionConfig(  # noqa: E731
        identity=ident,
        lease_duration=2.0,
        renew_deadline=1.2,
        retry_period=0.2,
        lock_name="disk-chaos",
    )
    disk_ok = [True]
    led_a, led_b = threading.Event(), threading.Event()
    a = LeaderElector(
        store, cfg("leader"), on_started_leading=led_a.set,
        disk_health=lambda: disk_ok[0],
    )
    b = LeaderElector(store, cfg("standby"), on_started_leading=led_b.set)
    ta = threading.Thread(target=a.run, daemon=True)
    tb = threading.Thread(target=b.run, daemon=True)
    ta.start()
    assert wait_until_disk(led_a.is_set, 10)
    tb.start()
    stepdowns0 = metrics.counter(COUNTER_DISK_STEPDOWNS)
    try:
        t0 = time.monotonic()
        disk_ok[0] = False  # the leader's disk dies
        assert wait_until_disk(led_b.is_set, 10), "standby never promoted"
        elapsed = time.monotonic() - t0
        assert metrics.counter(COUNTER_DISK_STEPDOWNS) > stepdowns0
        assert elapsed < cfg("x").lease_duration, (
            f"failover took {elapsed:.2f}s — that's lease-expiry takeover, "
            "not an active disk-death release"
        )
    finally:
        a.stop()
        b.stop()
        ta.join(timeout=5)
        tb.join(timeout=5)


# ---------------------------------------------------------------------------
# ENOSPC / disk-pressure ride-through + heal
# ---------------------------------------------------------------------------

def test_enospc_ride_through_and_heal(tmp_path):
    """ENOSPC mid-append degrades to DiskPressure read-only WITHOUT
    poisoning the sink; once space frees, a retried write reopens the
    store; recovery shows zero acked loss either side of the squeeze."""
    prefix = str(tmp_path / "enospc")
    wal = make_wal(tmp_path, "enospc")
    srv = APIServer(wal=wal)
    # pre-arm a deterministic probe so the auto-clear path is driven by
    # the test, not the real (never-full) filesystem under tmp_path
    probe = fake_probe(prefix, free_bytes=1 << 30)
    srv.disk_probe = probe
    inj = DiskFaultInjector(enospc_after_bytes=700).install(wal)

    created, squeezed = [], False
    for i in range(100):
        try:
            srv.create("pods", make_pod_disk(f"p{i}"))
            created.append(f"p{i}")
        except DiskPressure:
            squeezed = True
            break
    assert squeezed and created, "never hit the ENOSPC squeeze"
    assert srv.write_gate.disk_pressure
    assert wal.failed is None, "ENOSPC pre-fsync must not poison the sink"
    assert probe.under_pressure, (
        "ENOSPC entry must arm the probe's hysteresis or nothing clears"
    )
    assert metrics.gauge("store_disk_state") == 1.0
    assert len(srv.list("pods", "default")[0]) >= len(created)  # reads

    # space still low: writes keep 503ing as DiskPressure
    probe.free[0] = 0
    with pytest.raises(DiskPressure):
        srv.create("pods", make_pod_disk("still-full"))

    # space recovers: the next (client-retried) write reopens the store
    inj.free_space()
    probe.free[0] = 1 << 30
    srv.create("pods", make_pod_disk("healed"))
    assert not srv.write_gate.disk_pressure
    assert metrics.gauge("store_disk_state") == 0.0

    inj.uninstall()
    wal.close()
    report = WriteAheadLog.recover_report(prefix)
    assert not report.corrupt
    names = {p.metadata.name for p in report.objects["pods"].values()}
    for n in created:
        assert n in names, f"acked {n} lost across the ENOSPC squeeze"
    assert "healed" in names


def test_low_watermark_enters_read_only_before_writes_fail(tmp_path):
    """The probe trips the gate on the admission path BEFORE any append
    can hit ENOSPC — the sink is never even touched while gated."""
    prefix = str(tmp_path / "watermark")
    wal = make_wal(tmp_path, "watermark")
    srv = APIServer(wal=wal)
    inj = DiskFaultInjector().install(wal)
    probe = fake_probe(prefix, free_bytes=(32 << 20) - 1)
    assert probe.free[0] < probe.low_bytes
    srv.disk_probe = probe
    with pytest.raises(DiskPressure):
        srv.create("pods", make_pod_disk("early"))
    assert inj.write_calls == 0, "gated write must never reach the sink"
    assert srv.write_gate.disk_pressure
    # hysteresis: recovering past low but under high stays read-only
    probe.free[0] = probe.high_bytes - 1
    with pytest.raises(DiskPressure):
        srv.create("pods", make_pod_disk("between-watermarks"))
    probe.free[0] = probe.high_bytes
    srv.create("pods", make_pod_disk("recovered"))
    assert not srv.write_gate.disk_pressure
    inj.uninstall()


def test_fsync_stall_watchdog_flags_slow_disk(tmp_path):
    """A dying disk stretches fsyncs long before erroring: the watchdog
    gauge flips on a stalled fsync and clears on the next healthy one."""
    wal = make_wal(tmp_path, "stall", fsync=True)
    wal.FSYNC_STALL_S = 0.01
    inj = DiskFaultInjector(slow_fsyncs=(0,), fsync_delay_s=0.05).install(wal)
    stalls0 = metrics.counter(COUNTER_FSYNC_STALLS)
    wal.append(1, "create", "pods", make_pod_disk("slow"))
    assert metrics.counter(COUNTER_FSYNC_STALLS) == stalls0 + 1
    assert metrics.gauge("wal_fsync_stalled") == 1.0
    wal.append(2, "create", "pods", make_pod_disk("fast"))
    assert metrics.gauge("wal_fsync_stalled") == 0.0
    inj.uninstall()
    wal.close()


# ---------------------------------------------------------------------------
# compaction resilience + recovery-signal satellites
# ---------------------------------------------------------------------------

def test_compaction_failure_backs_off_then_recovers(tmp_path, monkeypatch):
    prefix = str(tmp_path / "compact")
    wal = make_wal(tmp_path, "compact", compact_every=3)
    srv = APIServer(wal=wal)
    real_snapshot = wal.write_snapshot
    fails0 = metrics.counter("wal_compaction_failures_total")

    def exploding_snapshot(rv, objects):
        raise OSError("simulated snapshot I/O error")

    monkeypatch.setattr(wal, "write_snapshot", exploding_snapshot)
    for i in range(4):
        srv.create("pods", make_pod_disk(f"p{i}"))
    # the failed compaction must clear the in-flight flag (no wedge)...
    assert wait_until_disk(lambda: not srv._compacting.is_set(), 10)
    assert wait_until_disk(
        lambda: metrics.counter("wal_compaction_failures_total") > fails0, 10
    )
    assert srv._compact_backoff_until > time.monotonic(), (
        "failure must arm backoff, not retry hot"
    )
    # ...and the append path kept working throughout
    srv.create("pods", make_pod_disk("during-backoff"))
    # past the backoff with a healthy disk, the next write compacts
    monkeypatch.setattr(wal, "write_snapshot", real_snapshot)
    srv._compact_backoff_until = 0.0
    srv.create("pods", make_pod_disk("trigger"))
    assert wait_until_disk(
        lambda: os.path.exists(prefix + ".snapshot.json"), 10
    ), "compaction never recovered after the backoff"
    wal.close()


def test_orphaned_compaction_tmp_files_swept_at_open(tmp_path):
    prefix = str(tmp_path / "orphans")
    for suffix in (".snapshot.json.tmp", ".wal.tmp"):
        with open(prefix + suffix, "w") as f:
            f.write("{half-written garbage from a crash mid-compaction")
    sweeps0 = metrics.counter(COUNTER_TMP_SWEEPS)
    wal = WriteAheadLog(prefix, native=False, fsync=False)
    assert not os.path.exists(prefix + ".snapshot.json.tmp")
    assert not os.path.exists(prefix + ".wal.tmp")
    assert metrics.counter(COUNTER_TMP_SWEEPS) == sweeps0 + 2
    wal.close()


def test_recover_staleness_retries_exhausted_is_surfaced(
    tmp_path, monkeypatch
):
    """recover_full exhausting its 10 staleness retries must say so
    (report flag + counter), never silently return possibly-torn state."""
    prefix = str(tmp_path / "stale")
    wal = make_wal(tmp_path, "stale")
    wal.write_snapshot(5, {"pods": [make_pod_disk("p0")]})
    wal.close()

    def always_stale(path):
        return RecoveryReport(rv=4, snap_rv=4)  # never matches disk's rv=5

    monkeypatch.setattr(
        WriteAheadLog, "_recover_once", staticmethod(always_stale)
    )
    exhausted0 = metrics.counter(COUNTER_RETRIES_EXHAUSTED)
    report = WriteAheadLog.recover_report(prefix)
    assert report.retries_exhausted
    assert metrics.counter(COUNTER_RETRIES_EXHAUSTED) == exhausted0 + 1


# ---------------------------------------------------------------------------
# fenced backup / restore: disaster recovery without split-brain
# ---------------------------------------------------------------------------

def test_restore_structurally_rejects_every_pre_restore_fence(tmp_path):
    # a live cluster with pods and a scheduler holding the lease
    src = APIServer()
    for i in range(4):
        src.create("pods", make_pod_disk(f"p{i}"))
    src.create("leases", Lease(
        metadata=v1.ObjectMeta(name="sched", namespace="kube-system"),
        holder_identity="sched-1",
        lease_transitions=3,
    ))
    zombie_fence = BindFence(
        namespace="kube-system", name="sched", identity="sched-1",
        transitions=3,
    )
    # sanity: the fence is valid against the LIVE cluster
    errs = src.bind_pods(
        [v1.Binding(pod_name="p0", pod_namespace="default",
                    target_node="n0")],
        fence=zombie_fence,
    )
    assert errs == [None]

    # disaster: online backup, restore into a fresh WAL, recover
    image = backup.backup_from_server(src, str(tmp_path / "img.json"))
    summary = backup.restore_into(
        backup.load_backup(str(tmp_path / "img.json")),
        str(tmp_path / "restored"),
    )
    assert summary["term"] == image["term"] + 1  # durable epoch bump
    assert summary["fenced_leases"] == 1
    restored = APIServer.recover(str(tmp_path / "restored"))
    assert restored.resource_version == image["rv"]
    assert not restored.disk_corrupt

    # EVERY pre-restore token is structurally rejected: the restored
    # lease has no holder and a bumped transition count, so the zombie's
    # identity AND transitions both mismatch — no wall clocks involved
    with pytest.raises(LeaderFenced):
        restored.bind_pods(
            [v1.Binding(pod_name="p1", pod_namespace="default",
                        target_node="n1")],
            fence=zombie_fence,
        )
    # the restored cluster itself is fully writable (unfenced paths)
    restored.create("pods", make_pod_disk("post-restore"))
    assert restored.bind_pods([
        v1.Binding(pod_name="p1", pod_namespace="default", target_node="n1")
    ]) == [None]


def test_restore_refuses_to_clobber_without_force(tmp_path):
    src = APIServer()
    src.create("pods", make_pod_disk("keep"))
    image = backup.backup_from_server(src, str(tmp_path / "img.json"))
    wal = make_wal(tmp_path, "occupied")
    wal.append(1, "create", "pods", make_pod_disk("resident"))
    wal.close()
    with pytest.raises(FileExistsError):
        backup.restore_into(image, str(tmp_path / "occupied"))
    with pytest.raises(NotFound):
        # the resident log was NOT touched by the refused restore
        APIServer.recover(str(tmp_path / "occupied")).get(
            "pods", "default", "keep"
        )
    backup.restore_into(image, str(tmp_path / "occupied"), force=True)
    restored = APIServer.recover(str(tmp_path / "occupied"))
    assert restored.get("pods", "default", "keep").metadata.name == "keep"


def test_offline_backup_of_corrupt_wal_flags_the_image(tmp_path):
    prefix = str(tmp_path / "sick")
    wal = make_wal(tmp_path, "sick")
    for i in range(6):
        wal.append(i + 1, "create", "pods", make_pod_disk(f"p{i}"))
    wal.close()
    bit_flip_record(prefix + ".wal", 2)
    image = backup.backup_from_wal(prefix, str(tmp_path / "sick.json"))
    assert image.get("source_corrupt") is True
    assert image["rv"] == 2  # honest: the longest valid prefix only


# -- tests/test_consensus.py -------------------------------------------
# Commit-index consensus (runtime/consensus.py): quorum-gated acks,
# degraded read-only mode, catch-up re-open, commit-index resync, and
# provably lossless failover (reference: etcd raft's commit index behind
# storage.Interface — an unreplicated write is never acknowledged).
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.runtime.consensus import (
    QuorumLost,
    RecordBuffer,
    vote_key,
)
from kubernetes_tpu_torch.runtime.replication import Follower, ReplicationListener

REPO_CONS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEAD_ADDR = ("127.0.0.1", 1)  # nothing ever listens here


def _pod_cons(name, node=""):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(
            node_name=node, containers=[v1.Container(requests={"cpu": "100m"})]
        ),
    )


def _wait(cond, timeout=5.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _cluster(n_followers, cluster_size, heartbeat_s=0.1, ack_timeout_s=1.0,
             lease_s=60.0, peers=False):
    """(primary, listener, followers): a consensus replica set, synced."""
    primary = APIServer()
    listener = ReplicationListener(
        heartbeat_s=heartbeat_s,
        ack_timeout_s=ack_timeout_s,
        cluster_size=cluster_size,
    )
    listener.attach(primary)
    fs = [
        Follower(
            listener.address,
            lease_s=lease_s,
            peers=[] if peers else None,
            cluster_size=cluster_size if peers else None,
            node_id=i + 1,
        ).start()
        for i in range(n_followers)
    ]
    if peers:
        for i, f in enumerate(fs):
            f.peers = [g.election_address for j, g in enumerate(fs) if j != i]
    for f in fs:
        assert f.wait_synced(5.0)
    return primary, listener, fs


# -- the ack contract ---------------------------------------------------------


def test_ack_implies_commit_on_majority():
    """Acceptance bar: an acknowledged write implies commit_index >= its
    rv AND a majority of the replica set (self included) durably holds
    it — verified against the coordinator's match table, and the commit
    index propagates to followers via heartbeat piggyback."""
    primary, listener, fs = _cluster(2, cluster_size=3)
    created = primary.create("pods", _pod_cons("acked"))
    rv = created.metadata.resource_version
    cons = listener.consensus
    assert cons.commit_index >= rv, "acked write below the commit index"
    assert cons.acked_quorum_size(rv) >= cons.majority, (
        f"ack implies majority durability: only "
        f"{cons.acked_quorum_size(rv)}/{cons.cluster_size} hold rv={rv}"
    )
    # followers learn the commit index (recs/hb piggyback): their election
    # votes carry it
    assert _wait(lambda: all(f.commit_index >= rv for f in fs)), (
        "followers never learned the commit index"
    )
    listener.close()
    for f in fs:
        f.stop()


def test_no_followers_never_acks_writes():
    """The hole this subsystem closes: a primary with ZERO connected
    followers in a 3-replica set must not acknowledge anything — the old
    availability-first path would have returned success with the write
    sitting only on the primary."""
    primary = APIServer()
    listener = ReplicationListener(ack_timeout_s=0.3, cluster_size=3)
    listener.attach(primary)
    with pytest.raises(QuorumLost):
        primary.create("pods", _pod_cons("solo"))
    assert primary.write_gate.degraded
    listener.close()


# -- partition semantics ------------------------------------------------------


# -- degraded mode lifecycle --------------------------------------------------


def test_follower_catchup_reopens_degraded_mode():
    """Acceptance bar: degraded mode lifts exactly when a quorum catches
    back up — here via a FRESH follower whose post-snapshot ack carries
    the commit index over the tip."""
    primary, listener, fs = _cluster(1, cluster_size=3, ack_timeout_s=0.3)
    primary.create("pods", _pod_cons("healthy"))
    fs[0].stop()
    assert _wait(lambda: listener.follower_count == 0, timeout=5.0)
    with pytest.raises(QuorumLost):
        primary.create("pods", _pod_cons("degrading"))
    assert primary.write_gate.degraded

    late = Follower(listener.address, lease_s=60.0).start()
    assert late.wait_synced(5.0)
    assert _wait(lambda: not primary.write_gate.degraded, timeout=5.0), (
        "fresh follower's catch-up never re-opened writes"
    )
    created = primary.create("pods", _pod_cons("recovered"))
    assert listener.consensus.commit_index >= created.metadata.resource_version
    listener.close()
    late.stop()
    for f in fs:
        f.stop()


def test_degraded_epoch_transitions_hit_the_wal(tmp_path):
    """The WAL records both epoch transitions (degraded + restored), and
    recover_full surfaces the commit index.

    The waits allow a loaded machine: the healthy write's ack has a 2 s
    window, a sync or a lift 30 s. The "restored" record is appended
    after the write gate lifts, off the coordinator's lock
    (``ConsensusCoordinator._after_reopen``), so the test waits for the
    record itself rather than reading the WAL as soon as the gate opens."""
    from kubernetes_tpu_torch.runtime.wal import WriteAheadLog, parse_wal_line

    wal = WriteAheadLog(str(tmp_path / "primary"), fsync=False)
    primary = APIServer(wal=wal)
    listener = ReplicationListener(ack_timeout_s=2.0, cluster_size=3)
    listener.attach(primary)
    f = Follower(listener.address, lease_s=60.0).start()
    assert f.wait_synced(30.0)
    primary.create("pods", _pod_cons("ok"))
    f.stop()
    assert _wait(lambda: listener.follower_count == 0, timeout=30.0)
    with pytest.raises(QuorumLost):
        primary.create("pods", _pod_cons("boom"))
    late = Follower(listener.address, lease_s=60.0).start()
    assert late.wait_synced(30.0)
    assert _wait(lambda: not primary.write_gate.degraded, timeout=30.0)

    def commit_events():
        wal_text = open(str(tmp_path / "primary") + ".wal").read()
        records = [
            parse_wal_line(line) for line in wal_text.splitlines() if line
        ]
        return [
            rec["event"]
            for rec in records
            if rec is not None and rec.get("verb") == "commit"
        ]

    assert _wait(lambda: "restored" in commit_events(), timeout=30.0)
    events = commit_events()
    assert "degraded" in events and "restored" in events
    rv, _objects, commit = WriteAheadLog.recover_full(str(tmp_path / "primary"))
    assert commit > 0 and rv >= commit
    listener.close()
    late.stop()


# -- commit-index resync ------------------------------------------------------


def test_reconnect_uses_catchup_not_snapshot():
    """A same-term reconnector whose suffix the leader still buffers gets
    a catchup replay (records since its rv), not a full snapshot."""
    from kubernetes_tpu_torch.utils.metrics import metrics

    primary, listener, fs = _cluster(2, cluster_size=3)
    for i in range(5):
        primary.create("pods", _pod_cons(f"pre-{i}"))
    f = fs[0]
    before = metrics.counter("apiserver_replication_catchup_resyncs_total")
    # cut f's link primary-side; its reconnect loop re-handshakes with
    # hello rv=5 and must get the (empty or tail) catchup path
    conn = listener._followers[0]
    listener._drop(conn)
    assert _wait(
        lambda: metrics.counter("apiserver_replication_catchup_resyncs_total")
        > before,
        timeout=5.0,
    ), "reconnect fell back to a full snapshot"
    primary.create("pods", _pod_cons("post-resync"))
    assert _wait(lambda: f.rv >= primary._rv and fs[1].rv >= primary._rv)
    listener.close()
    for f in fs:
        f.stop()


def test_quorum_miss_rechecks_commit_under_lock():
    """Regression: an ack racing the ship window's expiry means the write
    IS committed — quorum_miss must return None (ack the write) instead
    of wedging a healthy store in degraded mode that nothing would ever
    lift (rejected writes don't append; caught-up followers stop acking)."""
    from kubernetes_tpu_torch.runtime.consensus import ConsensusCoordinator

    cons = ConsensusCoordinator(cluster_size=3, window_s=0.01)
    cons.local_append(1)
    cons.follower_ack(7, 1)  # the "late" ack: commit now covers rv=1
    assert cons.quorum_miss(1) is None, "committed write treated as a miss"
    assert not cons.degraded
    # a genuinely uncovered rv still degrades
    cons.local_append(2)
    exc = cons.quorum_miss(2)
    assert exc is not None and cons.degraded
    # and the same late-ack path lifts it
    cons.follower_ack(7, 2)
    assert not cons.degraded


def test_record_buffer_suffix_semantics():
    buf = RecordBuffer(maxlen=4)
    assert buf.since(0) == []
    buf.extend([[1, "create", "pods", {}], [2, "create", "pods", {}]])
    assert [r[0] for r in buf.since(0)] == [1, 2]
    assert [r[0] for r in buf.since(1)] == [2]
    assert buf.since(2) == []
    buf.extend([[3, "c", "p", {}], [4, "c", "p", {}], [5, "c", "p", {}]])
    # 1 evicted (maxlen 4): a suffix from rv=0 is no longer provable
    assert buf.since(0) is None
    assert [r[0] for r in buf.since(1)] == [2, 3, 4, 5]


def test_vote_key_holds_records_over_learned_commit():
    """Safety: log length (rv) outranks a LEARNED commit claim — a lagging
    follower that heard commit=10 on a heartbeat but only holds rv=8 must
    lose to the follower that actually holds rv=10."""
    lagging = vote_key({"term": 1, "commit": 10, "rv": 8, "id": 9})
    holder = vote_key({"term": 1, "commit": 7, "rv": 10, "id": 1})
    assert holder > lagging
    # higher term still dominates everything
    assert vote_key({"term": 2, "commit": 0, "rv": 1, "id": 0}) > holder


# -- chaos + the consistency checker -----------------------------------------


def _dump_survivor(path, follower):
    """Survivor state in the checker's JSON form (a promoted or surviving
    in-memory replica)."""
    objects = follower.objects if follower.promoted is None else (
        follower.promoted._objects
    )
    state = {
        "rv": follower.rv if follower.promoted is None else follower.promoted._rv,
        "commit": follower.commit_index,
        "objects": {
            kind: {
                key: obj.metadata.resource_version for key, obj in d.items()
            }
            for kind, d in objects.items()
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(state, fh)


def test_chaos_kill_primary_zero_acked_write_loss(tmp_path):
    """Acceptance bar: kill the primary AND one follower mid-burst in a
    5-replica set; the survivors elect, and scripts/consistency_check.py
    proves ZERO acked-write loss (exit 0) from the client-visible ack log
    against the surviving replica states."""
    primary, listener, fs = _cluster(
        4, cluster_size=5, ack_timeout_s=1.0, lease_s=0.6, peers=True
    )
    ack_log = tmp_path / "acks.jsonl"
    acks = []
    dead = threading.Event()

    def writer():
        i = 0
        with open(ack_log, "w", encoding="utf-8") as fh:
            while not dead.is_set() and i < 400:
                name = f"burst-{i}"
                try:
                    created = primary.create("pods", _pod_cons(name))
                except Exception:
                    break  # NOT acknowledged: must not enter the ack log
                rec = {
                    "op": "create",
                    "kind": "pods",
                    "key": f"default/{name}",
                    "rv": created.metadata.resource_version,
                }
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                acks.append(rec)
                i += 1

    t = threading.Thread(target=writer)
    t.start()
    # kill mid-burst, but only once the burst is real: commit-gated
    # writes pace at follower-ack speed, so a fixed sleep under-shoots
    # on a loaded machine
    assert _wait(lambda: len(acks) >= 20, timeout=10.0), "burst never got going"
    listener.close()  # ...the primary dies
    fs[0].stop()  # ...and so does one follower
    dead.set()
    t.join()

    survivors = fs[1:]
    assert _wait(
        lambda: any(f.promoted is not None for f in survivors), timeout=15.0
    ), "no survivor promoted"
    time.sleep(1.0)
    promoted = [f for f in survivors if f.promoted is not None]
    assert len(promoted) == 1, f"{len(promoted)} leaders (split brain)"

    # external proof: the checker replays the ack log against the
    # surviving replica states and exits 0 iff nothing acked was lost
    paths = []
    for i, f in enumerate(survivors):
        p = tmp_path / f"survivor-{i}.json"
        _dump_survivor(p, f)
        paths.append(str(p))
    res = subprocess.run(
        [sys.executable, os.path.join(REPO_CONS, "scripts", "consistency_check.py"),
         str(ack_log), *paths],
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert res.returncode == 0, (
        f"acked-write loss detected:\n{res.stdout}\n{res.stderr}"
    )
    # and the checker is falsifiable: a fabricated ack must fail it
    with open(ack_log, "a", encoding="utf-8") as fh:
        fh.write(json.dumps({
            "op": "create", "kind": "pods",
            "key": "default/never-acked", "rv": 99999,
        }) + "\n")
    res2 = subprocess.run(
        [sys.executable, os.path.join(REPO_CONS, "scripts", "consistency_check.py"),
         str(ack_log), *paths],
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert res2.returncode == 1, "checker failed to detect an induced loss"
    for f in fs:
        f.stop()


def test_client_retries_degraded_503_until_reopen():
    """client-side contract: RESTClient transparently retries a degraded
    503 (honoring Retry-After) and succeeds once quorum recovery re-opens
    the store — the caller never sees the blip."""
    from kubernetes_tpu_torch.apiserver.client import RESTClient
    from kubernetes_tpu_torch.apiserver.rest import serve

    primary = APIServer()
    listener = ReplicationListener(ack_timeout_s=0.3, cluster_size=3)
    listener.attach(primary)
    f = Follower(listener.address, lease_s=60.0).start()
    assert f.wait_synced(5.0)
    primary.create("pods", _pod_cons("seed"))
    f.stop()
    assert _wait(lambda: listener.follower_count == 0, timeout=5.0)
    with pytest.raises(QuorumLost):
        primary.create("pods", _pod_cons("degrade-trigger"))
    assert primary.write_gate.degraded

    srv, port, _store = serve(primary, max_in_flight=0)
    client = RESTClient(f"http://127.0.0.1:{port}", degraded_retries=5)
    result = {}

    def attempt():
        try:
            result["obj"] = client.create("pods", _pod_cons("queued-write"))
        except Exception as e:  # pragma: no cover - surfaced by assert below
            result["err"] = e

    t = threading.Thread(target=attempt)
    t.start()
    time.sleep(0.3)  # let the first attempt hit the degraded 503
    late = Follower(listener.address, lease_s=60.0).start()
    assert late.wait_synced(5.0)
    t.join(timeout=20.0)
    assert not t.is_alive(), "client retry never returned"
    assert "err" not in result, f"retry surfaced: {result.get('err')}"
    assert result["obj"].metadata.name == "queued-write"
    srv.shutdown()
    listener.close()
    late.stop()
    f.stop()


@pytest.mark.slow
def test_soak_partition_heal_cycles_no_acked_loss():
    """Long soak: repeated degrade/heal cycles; every acknowledged write
    survives on the primary and the commit index covers it."""
    primary, listener, fs = _cluster(2, cluster_size=3, ack_timeout_s=0.3)
    acked = []
    for cycle in range(5):
        for i in range(20):
            created = primary.create("pods", _pod_cons(f"c{cycle}-{i}"))
            acked.append(
                (f"default/c{cycle}-{i}", created.metadata.resource_version)
            )
        # cut both links: next write degrades un-acked
        for conn in list(listener._followers):
            listener._drop(conn)
        try:
            primary.create("pods", _pod_cons(f"blip-{cycle}"))
        except QuorumLost:
            pass
        # heal: the followers' reconnect loops re-handshake and their acks
        # re-open the store
        assert _wait(lambda: not primary.write_gate.degraded, timeout=10.0), (
            f"cycle {cycle}: store never re-opened"
        )
    cons = listener.consensus
    store = primary._objects.get("pods", {})
    for key, rv in acked:
        assert key in store, f"acked {key} lost"
        assert cons.commit_index >= rv
    listener.close()
    for f in fs:
        f.stop()
