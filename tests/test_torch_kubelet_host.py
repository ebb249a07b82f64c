"""The rest of the port's kubelet (kubernetes_tpu_torch/kubelet/, copies of
the reference's) held to the reference's own tests: node-pressure
eviction, the device-plugin manager, the CSI node client, the volume
manager, the CRI wire protocol (its Scheduler at device="cpu"; the
protocol needs ``google.protobuf``) and the process runtime. Each
section below is the reference file named in its heading, with its
imports pointed at the port. Helpers that two reference files define
differently carry the file's tag. Tolerances: exact.
"""

# -- tests/test_kubelet_eviction.py ------------------------------------
# Kubelet node-pressure eviction + QoS classes (kubelet/eviction.py;
# reference pkg/kubelet/eviction/eviction_manager.go, helper/qos).
from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.kubelet.eviction import (
    MEMORY_PRESSURE_TAINT,
    QOS_BEST_EFFORT,
    QOS_BURSTABLE,
    QOS_GUARANTEED,
    EvictionManager,
    qos_class,
)
from kubernetes_tpu_torch.kubelet.kubelet import make_node_object


def _pod(name, mem=None, lim=None, prio=0, node="n0"):
    reqs = {"memory": mem} if mem else {}
    lims = {"memory": lim, "cpu": "1"} if lim else {}
    if lim and mem:
        reqs["cpu"] = "1"
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(
            node_name=node,
            priority=prio,
            containers=[v1.Container(requests=reqs, limits=lims)],
        ),
        status=v1.PodStatus(phase=v1.POD_RUNNING),
    )


def test_qos_classes():
    assert qos_class(_pod("be")) == QOS_BEST_EFFORT
    assert qos_class(_pod("burst", mem="1Gi")) == QOS_BURSTABLE
    assert qos_class(_pod("guar", mem="1Gi", lim="1Gi")) == QOS_GUARANTEED


def test_eviction_ranks_best_effort_first_and_taints_node():
    server = APIServer()
    server.create("nodes", make_node_object("n0", memory="1Gi"))
    server.create("pods", _pod("guar", mem="512Mi", lim="512Mi", prio=100))
    server.create("pods", _pod("burst", mem="400Mi"))
    be = _pod("be")
    server.create("pods", be)
    # give the BestEffort pod synthetic usage so pressure exists
    usage = {
        "default/guar": 512 << 20,
        "default/burst": 400 << 20,
        "default/be": 200 << 20,
    }
    em = EvictionManager(
        server,
        "n0",
        memory_threshold_bytes=64 << 20,
        usage_fn=lambda p: usage.get(p.metadata.key, 0),
    )
    evicted = em.synchronize()
    assert evicted == ["default/be"], evicted  # BestEffort goes first
    p = server.get("pods", "default", "be")
    assert p.status.phase == v1.POD_FAILED and p.status.reason == "Evicted"
    node = server.get("nodes", "", "n0")
    assert any(
        c.type == "MemoryPressure" and c.status == "True"
        for c in node.status.conditions
    )
    assert any(t.key == MEMORY_PRESSURE_TAINT for t in node.spec.taints)

    # pressure clears once usage drops below threshold: condition + taint go
    usage["default/be"] = 0
    usage["default/burst"] = 0
    assert em.synchronize() == []
    node = server.get("nodes", "", "n0")
    assert any(
        c.type == "MemoryPressure" and c.status == "False"
        for c in node.status.conditions
    )
    assert not any(t.key == MEMORY_PRESSURE_TAINT for t in node.spec.taints)


def test_guaranteed_within_requests_evicted_last():
    server = APIServer()
    server.create("nodes", make_node_object("n0", memory="1Gi"))
    server.create("pods", _pod("guar", mem="900Mi", lim="900Mi", prio=1000))
    server.create("pods", _pod("burst-over", mem="64Mi"))
    usage = {"default/guar": 900 << 20, "default/burst-over": 120 << 20}
    em = EvictionManager(
        server,
        "n0",
        memory_threshold_bytes=64 << 20,
        usage_fn=lambda p: usage.get(p.metadata.key, 0),
    )
    # burst-over exceeds its request: it is the victim, not the bigger
    # guaranteed pod living within its requests
    assert em.synchronize() == ["default/burst-over"]


def test_container_manager_allocatable_and_cgroups():
    """pkg/kubelet/cm: allocatable = capacity - reservations; pod cgroup
    paths follow the /kubepods/{qos}/pod{uid} layout."""
    from kubernetes_tpu_torch.kubelet.cm import ContainerManager

    cm = ContainerManager(
        system_reserved={"cpu": "500m", "memory": "512Mi"},
        kube_reserved={"cpu": "1", "memory": "1Gi"},
        eviction_hard_memory="100Mi",
    )
    alloc = cm.node_allocatable({"cpu": "8", "memory": "16Gi", "pods": "110"})
    assert alloc["cpu"] == "6500m"
    assert alloc["memory"] == str((16 << 30) - (512 << 20) - (1 << 30) - (100 << 20))
    assert alloc["pods"] == "110"

    guar = _pod("g", mem="1Gi", lim="1Gi")
    guar.metadata.uid = "u1"
    assert cm.pod_cgroup(guar) == "/kubepods/podu1"
    burst = _pod("b", mem="1Gi")
    burst.metadata.uid = "u2"
    assert cm.pod_cgroup(burst) == "/kubepods/burstable/podu2"
    be = _pod("e")
    be.metadata.uid = "u3"
    assert cm.pod_cgroup(be) == "/kubepods/besteffort/podu3"


def test_kubelet_posts_reserved_allocatable():
    """The kubelet posts allocatable = capacity - reservations to the
    node status (the Node Allocatable KEP), so the scheduler packs
    against reserved-aware capacity."""
    from kubernetes_tpu_torch.api.resources import cpu_to_millis
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.kubelet.cm import ContainerManager
    from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, make_node_object
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime
    from kubernetes_tpu_torch.kubemark.hollow_node import _fake_pod_ip

    server = APIServer()
    server.create("nodes", make_node_object("n0", cpu="8"))
    kl = Kubelet(server, "n0", FakeRuntime(_fake_pod_ip))
    kl.container_manager = ContainerManager(kube_reserved={"cpu": "1"})
    kl.sync_node_allocatable()
    node = server.get("nodes", "", "n0")
    assert cpu_to_millis(node.status.allocatable["cpu"]) == 7000
    assert cpu_to_millis(node.status.capacity["cpu"]) == 8000


# -- tests/test_devicemanager.py ---------------------------------------
# Kubelet device-plugin manager (kubelet/devicemanager.py; reference
# pkg/kubelet/cm/devicemanager/manager.go + topology_hints.go).
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.kubelet.devicemanager import (
    Device,
    DeviceManager,
    DevicePluginStub,
)
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, make_node_object
from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

RES = "tpu.dev/chip"


def _mk(tmp_path, policy="best-effort", devices=None, checkpoint=None):
    dm = DeviceManager(
        str(tmp_path / "kubelet_device.sock"),
        checkpoint_path=str(tmp_path / (checkpoint or "device_state.json")),
        policy=policy,
    )
    dm.start()
    stub = DevicePluginStub(
        dm.socket_path,
        RES,
        devices
        or [
            Device("d0", topology=0),
            Device("d1", topology=0),
            Device("d2", topology=1),
            Device("d3", topology=1),
        ],
    )
    stub.start()
    deadline = time.monotonic() + 5.0
    while RES not in dm.capacities() and time.monotonic() < deadline:
        time.sleep(0.01)
    return dm, stub


def _pod_dm(name, n_chips):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={RES: str(n_chips)})]),
    )


def test_register_capacity_and_health_updates(tmp_path):
    dm, stub = _mk(tmp_path)
    try:
        assert dm.capacities() == {RES: 4}
        # ListAndWatch push: one chip goes unhealthy
        stub.update_devices(
            [
                Device("d0", topology=0),
                Device("d1", healthy=False, topology=0),
                Device("d2", topology=1),
                Device("d3", topology=1),
            ]
        )
        deadline = time.monotonic() + 5.0
        while dm.capacities()[RES] != 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dm.capacities() == {RES: 3}
    finally:
        stub.stop()
        dm.stop()


def test_allocation_prefers_topology_alignment(tmp_path):
    dm, stub = _mk(tmp_path)
    try:
        got = dm.allocate_pod(_pod_dm("p1", 2))
        ids = got[RES]
        assert len(ids) == 2
        # both devices from ONE locality domain
        doms = {0 if i in ("d0", "d1") else 1 for i in ids}
        assert len(doms) == 1, ids
        # the plugin observed the Allocate call with exactly these ids
        deadline = time.monotonic() + 5.0
        while not stub.allocated and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(stub.allocated[0]) == sorted(ids)
        # second pod gets the OTHER domain, still aligned
        got2 = dm.allocate_pod(_pod_dm("p2", 2))
        assert not set(got2[RES]) & set(ids)
    finally:
        stub.stop()
        dm.stop()


def test_restricted_policy_rejects_unaligned(tmp_path):
    dm, stub = _mk(tmp_path, policy="restricted")
    try:
        # 3 chips cannot come from a single 2-chip domain
        with pytest.raises(RuntimeError, match="restricted"):
            dm.allocate_pod(_pod_dm("big", 3))
        # best-effort on the same shape proceeds unaligned
    finally:
        stub.stop()
        dm.stop()
    dm2, stub2 = _mk(tmp_path, policy="best-effort", checkpoint="s2.json")
    try:
        got = dm2.allocate_pod(_pod_dm("big", 3))
        assert len(got[RES]) == 3
    finally:
        stub2.stop()
        dm2.stop()


def test_checkpoint_restore_preserves_allocations(tmp_path):
    dm, stub = _mk(tmp_path)
    try:
        got = dm.allocate_pod(_pod_dm("p1", 2))
    finally:
        stub.stop()
        dm.stop()
    # kubelet restart: a fresh manager restores the allocation from disk
    dm2 = DeviceManager(
        str(tmp_path / "kubelet_device2.sock"),
        checkpoint_path=str(tmp_path / "device_state.json"),
    )
    dm2.start()
    stub2 = DevicePluginStub(dm2.socket_path, RES, [
        Device("d0", topology=0), Device("d1", topology=0),
        Device("d2", topology=1), Device("d3", topology=1),
    ])
    stub2.start()
    try:
        deadline = time.monotonic() + 5.0
        while RES not in dm2.capacities() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dm2.allocations("default/p1") == got
        # restored in-use devices are NOT re-granted
        got2 = dm2.allocate_pod(_pod_dm("p2", 2))
        assert not set(got2[RES]) & set(got[RES])
    finally:
        stub2.stop()
        dm2.stop()


def test_kubelet_surfaces_capacity_and_admits_device_pods(tmp_path):
    """End to end: plugin capacity reaches NodeStatus (where the scheduler's
    NodeResourcesFit sees it as an extended resource), an admitted pod gets
    devices, an oversized pod fails with UnexpectedAdmissionError."""
    server = APIServer()
    server.create("nodes", make_node_object("n0"))
    dm, stub = _mk(tmp_path)
    from kubernetes_tpu_torch.kubemark.hollow_node import _fake_pod_ip

    kl = Kubelet(server, "n0", FakeRuntime(_fake_pod_ip), device_manager=dm)
    try:
        kl.sync_device_capacity()
        node = server.get("nodes", "", "n0")
        assert node.status.capacity[RES] == 4
        assert node.status.allocatable[RES] == 4

        ok = _pod_dm("uses-chips", 2)
        ok.spec.node_name = "n0"
        server.create("pods", ok)
        kl.handle_pod_event("ADDED", server.get("pods", "default", "uses-chips"))
        assert len(dm.allocations("default/uses-chips")[RES]) == 2
        assert (
            server.get("pods", "default", "uses-chips").status.phase
            == v1.POD_RUNNING
        )

        big = _pod_dm("too-big", 5)
        big.spec.node_name = "n0"
        server.create("pods", big)
        kl.handle_pod_event("ADDED", server.get("pods", "default", "too-big"))
        p = server.get("pods", "default", "too-big")
        assert p.status.phase == v1.POD_FAILED
        assert p.status.reason == "UnexpectedAdmissionError"

        # deletion frees the devices
        kl.handle_pod_event(
            "DELETED", server.get("pods", "default", "uses-chips")
        )
        assert dm.allocations("default/uses-chips") == {}
    finally:
        stub.stop()
        dm.stop()


# -- tests/test_csi.py -------------------------------------------------
# CSI node-driver boundary: stage/publish ordering around pod volume
# setup, driver-absent pending behavior, teardown on pod removal.
#
# Reference: pkg/volume/csi/csi_client.go (NodeStage/Publish/Unpublish/
# Unstage) driven from the kubelet volume manager's reconciler.
import socket
import threading

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.kubelet.csi import CSIDriverManager, CSIError
from kubernetes_tpu_torch.kubelet.devicemanager import _recv_frame, _reply
from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager


class FakeCSIDriver:
    """External driver process stand-in: answers the node service over a
    framed unix socket and records the call sequence."""

    def __init__(self, path: str):
        self.path = path
        self.calls = []
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._stop = False
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                method, payload = _recv_frame(conn)
                self.calls.append((method, payload))
                _reply(conn, 0, {"ok": True})
            except OSError:
                pass
            finally:
                conn.close()

    def close(self):
        self._stop = True
        self._sock.close()


@pytest.fixture
def driver(tmp_path):
    d = FakeCSIDriver(str(tmp_path / "csi.sock"))
    yield d
    d.close()


def _cluster(csi):
    server = APIServer()
    server.create(
        "nodes",
        v1.Node(metadata=v1.ObjectMeta(name="n0", namespace="")),
    )
    server.create(
        "persistentvolumes",
        v1.PersistentVolume(
            metadata=v1.ObjectMeta(name="pv-csi", namespace=""),
            spec=v1.PersistentVolumeSpec(
                csi=v1.CSIVolumeSource(
                    driver="ebs.csi.example.com", volume_handle="vol-1"
                )
            ),
        ),
    )
    server.create(
        "persistentvolumeclaims",
        v1.PersistentVolumeClaim(
            metadata=v1.ObjectMeta(name="claim"),
            spec=v1.PersistentVolumeClaimSpec(volume_name="pv-csi"),
        ),
    )
    server.create(
        "volumeattachments",
        v1.VolumeAttachment(
            metadata=v1.ObjectMeta(name="va-1", namespace=""),
            spec=v1.VolumeAttachmentSpec(pv_name="pv-csi", node_name="n0"),
            status=v1.VolumeAttachmentStatus(attached=True),
        ),
    )
    vm = VolumeManager(server, "n0", csi=csi)
    pod = v1.Pod(
        metadata=v1.ObjectMeta(name="p0"),
        spec=v1.PodSpec(
            node_name="n0",
            volumes=[v1.Volume(name="v", persistent_volume_claim="claim")],
        ),
    )
    return server, vm, pod


def test_stage_publish_unpublish_unstage_sequence(driver):
    csi = CSIDriverManager("n0")
    csi.register("ebs.csi.example.com", driver.path)
    server, vm, pod = _cluster(csi)

    vm.note_pod(pod)
    vm.reconcile()
    assert vm.mounts_ready(pod)
    assert [m for m, _ in driver.calls] == [
        "NodeStageVolume",
        "NodePublishVolume",
    ]
    assert driver.calls[1][1]["target"] == pod.metadata.key

    # a second pod on the same volume publishes WITHOUT re-staging
    pod2 = v1.Pod(
        metadata=v1.ObjectMeta(name="p1"),
        spec=v1.PodSpec(
            node_name="n0",
            volumes=[v1.Volume(name="v", persistent_volume_claim="claim")],
        ),
    )
    vm.note_pod(pod2)
    vm.reconcile()
    assert [m for m, _ in driver.calls] == [
        "NodeStageVolume",
        "NodePublishVolume",
        "NodePublishVolume",
    ]

    # first pod leaves: unpublish only (volume still in use by pod2)
    vm.forget_pod(pod.metadata.key)
    vm.reconcile()
    assert driver.calls[-1][0] == "NodeUnpublishVolume"
    assert csi.staged() == [("ebs.csi.example.com", "vol-1")]

    # last pod leaves: unpublish + unstage
    vm.forget_pod(pod2.metadata.key)
    vm.reconcile()
    assert [m for m, _ in driver.calls[-2:]] == [
        "NodeUnpublishVolume",
        "NodeUnstageVolume",
    ]
    assert csi.staged() == []
    assert not vm.mounted_for(pod2.metadata.key)


def test_missing_driver_leaves_volume_pending_then_recovers(driver):
    """No registered driver: the pod's volume stays un-ready (the
    reference's missing-CSI-plugin behavior); registration + the next
    reconcile pass recover without restart."""
    csi = CSIDriverManager("n0")
    server, vm, pod = _cluster(csi)
    vm.note_pod(pod)
    vm.reconcile()
    assert not vm.mounts_ready(pod)
    assert driver.calls == []

    csi.register("ebs.csi.example.com", driver.path)
    vm.reconcile()
    assert vm.mounts_ready(pod)


def test_unregistered_call_raises():
    csi = CSIDriverManager("n0")
    with pytest.raises(CSIError):
        csi.stage_and_publish(
            v1.CSIVolumeSource(driver="nope", volume_handle="v"), "ns/p"
        )


def test_in_tree_pv_does_not_touch_csi(driver):
    """A GCE-PD PV must never reach the CSI boundary."""
    csi = CSIDriverManager("n0")
    csi.register("ebs.csi.example.com", driver.path)
    server, vm, pod = _cluster(csi)
    server.guaranteed_update(
        "persistentvolumes", "", "pv-csi",
        lambda pv: (
            setattr(pv.spec, "csi", None),
            setattr(
                pv.spec,
                "gce_persistent_disk",
                v1.GCEPersistentDiskVolumeSource(pd_name="d"),
            ),
            pv,
        )[-1],
    )
    vm.note_pod(pod)
    vm.reconcile()
    assert vm.mounts_ready(pod)
    assert driver.calls == []


def test_failed_teardown_is_retried(tmp_path, driver):
    """Driver down at pod deletion: the pair stays mounted and the next
    reconcile (driver back) re-issues NodeUnpublish + NodeUnstage."""
    csi = CSIDriverManager("n0")
    csi.register("ebs.csi.example.com", driver.path)
    server, vm, pod = _cluster(csi)
    vm.note_pod(pod)
    vm.reconcile()
    assert vm.mounts_ready(pod)

    # driver goes away; pod deleted
    csi.register("ebs.csi.example.com", str(driver.path) + ".gone")
    vm.forget_pod(pod.metadata.key)
    vm.reconcile()
    # teardown failed -> still tracked, still staged
    assert vm.mounted_for(pod.metadata.key) == ["pv-csi"]
    assert csi.staged() == [("ebs.csi.example.com", "vol-1")]

    # driver returns: the retry completes the teardown
    csi.register("ebs.csi.example.com", driver.path)
    vm.reconcile()
    assert vm.mounted_for(pod.metadata.key) == []
    assert csi.staged() == []
    assert [m for m, _ in driver.calls[-2:]] == [
        "NodeUnpublishVolume",
        "NodeUnstageVolume",
    ]


# -- tests/test_volumemanager.py ---------------------------------------
# Kubelet volume manager: attach → mount → pod start ordering, in-use
# reporting, safe detach (kubelet/volumemanager.py; reference
# pkg/kubelet/volumemanager/volume_manager.go).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.controller.attachdetach import AttachDetachController
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, make_node_object
from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime
from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager
from kubernetes_tpu_torch.kubemark.hollow_node import _fake_pod_ip


def _pv(name):
    return v1.PersistentVolume(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        spec=v1.PersistentVolumeSpec(
            capacity={"storage": "10Gi"},
            gce_persistent_disk=v1.GCEPersistentDiskVolumeSource(pd_name=name),
        ),
    )


def _pvc(name, pv):
    return v1.PersistentVolumeClaim(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PersistentVolumeClaimSpec(volume_name=pv),
        status=v1.PersistentVolumeClaimStatus(phase="Bound"),
    )


def _pod_vm(name, pvc, node="n0"):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(
            node_name=node,
            containers=[v1.Container(requests={"cpu": "100m"})],
            volumes=[v1.Volume(name="data", persistent_volume_claim=pvc)],
        ),
    )


def _setup():
    server = APIServer()
    server.create("nodes", make_node_object("n0"))
    server.create("persistentvolumes", _pv("pv1"))
    server.create("persistentvolumeclaims", _pvc("claim1", "pv1"))
    vm = VolumeManager(server, "n0")
    kl = Kubelet(server, "n0", FakeRuntime(_fake_pod_ip))
    kl.volume_manager = vm
    return server, vm, kl


def test_pod_waits_for_attach_then_mounts_and_starts():
    server, vm, kl = _setup()
    server.create("pods", _pod_vm("p1", "claim1"))
    pod = server.get("pods", "default", "p1")
    # no VolumeAttachment yet: the pod parks, not started
    kl.handle_pod_event("ADDED", pod)
    assert server.get("pods", "default", "p1").status.phase == "Pending"
    assert "default/p1" in kl._wait_volumes
    # volumes_in_use already reports intent (desired state)
    assert server.get("nodes", "", "n0").status.volumes_in_use == ["pv1"]

    # the attach-detach controller attaches (pod is scheduled to n0)
    ad = AttachDetachController(server)
    ad.sync("reconcile")
    vas, _ = server.list("volumeattachments")
    assert len(vas) == 1 and vas[0].spec.pv_name == "pv1"

    # housekeeping reconciles the mount and starts the parked pod
    kl.housekeeping()
    assert server.get("pods", "default", "p1").status.phase == v1.POD_RUNNING
    assert vm.mounted_for("default/p1") == ["pv1"]
    assert not kl._wait_volumes


def test_safe_detach_waits_for_unmount():
    server, vm, kl = _setup()
    server.create("pods", _pod_vm("p1", "claim1"))
    ad = AttachDetachController(server)
    ad.sync("reconcile")
    kl.handle_pod_event("ADDED", server.get("pods", "default", "p1"))
    kl.housekeeping()
    assert vm.mounted_for("default/p1") == ["pv1"]

    # pod deleted, but the kubelet hasn't torn down yet: detach must wait
    server.delete("pods", "default", "p1")
    ad.sync("reconcile")
    vas, _ = server.list("volumeattachments")
    assert len(vas) == 1, "detached while still mounted"

    # kubelet tears down -> volumes_in_use clears -> detach proceeds
    kl.handle_pod_event("DELETED", _pod_vm("p1", "claim1"))
    kl.housekeeping()
    assert server.get("nodes", "", "n0").status.volumes_in_use == []
    ad.sync("reconcile")
    vas, _ = server.list("volumeattachments")
    assert vas == []


def test_non_pvc_pods_unaffected():
    server, vm, kl = _setup()
    plain = v1.Pod(
        metadata=v1.ObjectMeta(name="plain"),
        spec=v1.PodSpec(node_name="n0", containers=[v1.Container()]),
    )
    server.create("pods", plain)
    kl.handle_pod_event("ADDED", server.get("pods", "default", "plain"))
    assert (
        server.get("pods", "default", "plain").status.phase == v1.POD_RUNNING
    )


# -- tests/test_cri_wire.py --------------------------------------------
# CRI wire: the kubelet drives pods through a real process-boundary
# socket speaking protobuf (reference cri-api api.proto + remote_runtime.go).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.kubelet.cri import CRIServer, RemoteRuntime
from kubernetes_tpu_torch.kubelet.kubelet import NodeAgentPool
from kubernetes_tpu_torch.kubelet.runtime import ANN_RUN_SECONDS, FakeRuntime
from kubernetes_tpu_torch.kubemark.hollow_node import _fake_pod_ip, make_hollow_node
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler


def wait_until(fn, timeout=30.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def test_cri_roundtrip_direct(tmp_path):
    sock = str(tmp_path / "cri.sock")
    server = CRIServer(FakeRuntime(_fake_pod_ip), sock)
    server.start()
    try:
        rt = RemoteRuntime(sock)
        assert rt.version().startswith("kubernetes-tpu-fake")
        pod = v1.Pod(
            metadata=v1.ObjectMeta(name="sandboxed", labels={"app": "x"}),
            spec=v1.PodSpec(),
        )
        ip = rt.run_pod(pod)
        assert ip.startswith("10.")
        assert rt.relist() == {"default/sandboxed": v1.POD_RUNNING}
        rt.kill_pod("default/sandboxed")
        assert rt.relist() == {}
        rt.close()
    finally:
        server.stop()


def test_cri_scripted_completion_crosses_the_wire(tmp_path):
    """The fake runtime's completion scripting rides the sandbox
    annotations, so PLEG observes terminal phases through the socket."""
    sock = str(tmp_path / "cri2.sock")
    server = CRIServer(FakeRuntime(_fake_pod_ip), sock)
    server.start()
    try:
        rt = RemoteRuntime(sock)
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name="short", annotations={ANN_RUN_SECONDS: "0.2"}
            ),
            spec=v1.PodSpec(),
        )
        rt.run_pod(pod)
        assert wait_until(
            lambda: rt.relist().get("default/short") == v1.POD_SUCCEEDED,
            timeout=10,
        )
        rt.close()
    finally:
        server.stop()


def test_kubelet_runs_pods_over_cri_socket(tmp_path):
    """The UNCHANGED kubelet sync loop drives pods through the wire: the
    pool's runtime factory returns RemoteRuntime, the runtime process is a
    CRIServer on a unix socket."""
    sock = str(tmp_path / "cri3.sock")
    cri = CRIServer(FakeRuntime(_fake_pod_ip), sock)
    cri.start()
    store = APIServer()
    pool = NodeAgentPool(
        store,
        housekeeping_interval=0.1,
        runtime_factory=lambda node: RemoteRuntime(sock),
    )
    store.create("nodes", make_hollow_node("cri-node"))
    pool.add_node("cri-node", register=False)
    sched = Scheduler(store, KubeSchedulerConfiguration(), device="cpu")
    pool.start()
    sched.start()
    try:
        store.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name="wired"),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
            ),
        )

        def running():
            p = store.get("pods", "default", "wired")
            return (
                p.spec.node_name == "cri-node"
                and p.status.phase == v1.POD_RUNNING
                and p.status.pod_ip.startswith("10.")
            )

        assert wait_until(running, timeout=60), "pod must run via the CRI socket"
    finally:
        sched.stop()
        pool.stop()
        cri.stop()


# -- tests/test_processruntime.py --------------------------------------
# ProcessRuntime: real host-process supervision behind the PodRuntime
# boundary — real exit codes, signals, logs, exec, /proc stats — plus the
# same runtime driven across the framed CRI socket.
#
# Reference: pkg/kubelet/kuberuntime (SyncPod container lifecycle) and the
# CRI remote runtime (pkg/kubelet/remote/remote_runtime.go).
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.kubelet.processruntime import ProcessRuntime


def _ip_alloc(uid):
    return "10.0.0.7"


def _pod_pr(name, command, args=()):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, uid=f"u-{name}"),
        spec=v1.PodSpec(
            node_name="n0",
            containers=[
                v1.Container(name="main", command=list(command), args=list(args))
            ],
        ),
    )


def _wait_phase(rt, key, phase, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.relist().get(key) == phase:
            return True
        time.sleep(0.05)
    return rt.relist().get(key) == phase


def test_exit_codes_drive_phases(tmp_path):
    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    ok = _pod_pr("ok", ["/bin/sh", "-c", "echo done"])
    bad = _pod_pr("bad", ["/bin/sh", "-c", "exit 3"])
    run = _pod_pr("run", ["/bin/sleep", "60"])
    for p in (ok, bad, run):
        rt.run_pod(p)
    assert _wait_phase(rt, ok.metadata.key, v1.POD_SUCCEEDED)
    assert _wait_phase(rt, bad.metadata.key, v1.POD_FAILED)
    assert rt.relist()[run.metadata.key] == v1.POD_RUNNING
    assert rt.probe(run.metadata.key, "liveness")
    assert not rt.probe(ok.metadata.key, "liveness")
    rt.kill_pod(run.metadata.key)
    assert run.metadata.key not in rt.relist()


def test_logs_capture_real_output(tmp_path):
    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    p = _pod_pr("logger", ["/bin/sh", "-c", "echo line1; echo line2; sleep 30"])
    rt.run_pod(p)
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if "line2" in rt.logs(p.metadata.key):
                break
            time.sleep(0.05)
        text = rt.logs(p.metadata.key)
        assert "line1" in text and "line2" in text
        assert rt.logs(p.metadata.key, tail_lines=1).strip() == "line2"
    finally:
        rt.kill_pod(p.metadata.key)


def test_sigterm_then_sigkill_tree(tmp_path):
    """A trap-ignoring process must still die via the SIGKILL escalation,
    including its children (process-group kill)."""
    rt = ProcessRuntime(_ip_alloc, str(tmp_path), grace_s=0.3)
    p = _pod_pr(
        "stubborn",
        ["/bin/sh", "-c", "trap '' TERM; /bin/sleep 300 & wait"],
    )
    rt.run_pod(p)
    time.sleep(0.2)
    t0 = time.monotonic()
    rt.kill_pod(p.metadata.key)
    assert time.monotonic() - t0 < 8
    assert p.metadata.key not in rt.relist()


def test_exec_and_stats(tmp_path):
    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    p = _pod_pr("w", ["/bin/sleep", "60"])
    rt.run_pod(p)
    try:
        out = rt.exec(p.metadata.key, ["/bin/echo", "hi"])
        assert out.strip() == "hi"
        cpu, rss = rt.pod_stats(p.metadata.key)
        assert rss > 0  # a live sleep still has resident pages
        with pytest.raises(KeyError):
            rt.exec("nope/nope", ["/bin/true"])
    finally:
        rt.kill_pod(p.metadata.key)


def test_restart_pod_recreates_processes(tmp_path):
    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    p = _pod_pr("r", ["/bin/sh", "-c", "echo boot; sleep 60"])
    rt.run_pod(p)
    try:
        time.sleep(0.3)
        rt.restart_pod(p.metadata.key)
        assert rt.relist()[p.metadata.key] == v1.POD_RUNNING
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if rt.logs(p.metadata.key).count("boot") >= 2:
                break
            time.sleep(0.05)
        # the log survived the restart and shows both boots
        assert rt.logs(p.metadata.key).count("boot") >= 2
    finally:
        rt.kill_pod(p.metadata.key)


def test_over_the_cri_wire(tmp_path):
    """The same real processes driven across the framed CRI socket: the
    kubelet side never knows which side of the boundary it is on."""
    from kubernetes_tpu_torch.kubelet.cri.wire import CRIServer, RemoteRuntime

    rt = ProcessRuntime(_ip_alloc, str(tmp_path / "pods"))
    srv = CRIServer(rt, str(tmp_path / "cri.sock"))
    srv.start()
    remote = RemoteRuntime(str(tmp_path / "cri.sock"))
    p = _pod_pr("wire", ["/bin/sh", "-c", "echo over-the-wire; sleep 5"])
    try:
        remote.run_pod(p)
        # the container REALLY ran remotely: its output is visible through
        # the ContainerLogs RPC while it is still Running (guards against
        # the command being dropped at the wire and the empty pod
        # vacuously 'succeeding')
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if "over-the-wire" in remote.logs(p.metadata.key):
                break
            time.sleep(0.05)
        assert "over-the-wire" in remote.logs(p.metadata.key)
        assert remote.relist()[p.metadata.key] == v1.POD_RUNNING
        # real exec through ExecSync
        assert remote.exec(p.metadata.key, ["/bin/echo", "rpc"]).strip() == "rpc"
        remote.kill_pod(p.metadata.key)
        assert p.metadata.key not in remote.relist()
    finally:
        remote.close()
        srv.stop()


def test_cri_image_service(tmp_path):
    """ImageService subset over the wire: Pull/List/Status/Remove/FsInfo
    (reference RuntimeService sibling in cri-api api.proto)."""
    from kubernetes_tpu_torch.kubelet.cri.wire import CRIServer, RemoteRuntime
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

    srv = CRIServer(FakeRuntime(_ip_alloc), str(tmp_path / "cri.sock"))
    srv.start()
    remote = RemoteRuntime(str(tmp_path / "cri.sock"))
    try:
        assert remote.image_status("busybox:1.36") is None
        ref = remote.pull_image("busybox:1.36")
        assert ref == "sha256:busybox:1.36"
        remote.pull_image("app:v2")
        assert set(remote.list_images()) == {"busybox:1.36", "app:v2"}
        assert remote.image_status("busybox:1.36") is not None
        used, cap = remote.image_fs_info()
        assert 0 < used < cap
        remote.remove_image("app:v2")
        assert set(remote.list_images()) == {"busybox:1.36"}
    finally:
        remote.close()
        srv.stop()


def test_real_stats_reach_metrics_api(tmp_path):
    """cAdvisor flow end-to-end: a real busy process's /proc usage flows
    kubelet housekeeping -> pod annotations -> metrics.k8s.io -> kubectl
    top's data source."""
    import json
    import urllib.request

    from kubernetes_tpu_torch.apiserver.rest import serve
    from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, make_node_object

    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    srv, port, store = serve()
    try:
        store.create("nodes", make_node_object("n0"))
        kl = Kubelet(store, "n0", rt)
        # a pod that actually burns CPU
        p = v1.Pod(
            metadata=v1.ObjectMeta(name="burner"),
            spec=v1.PodSpec(
                node_name="n0",
                containers=[
                    v1.Container(
                        name="spin",
                        command=[
                            "/bin/sh", "-c",
                            "while true; do :; done",
                        ],
                    )
                ],
            ),
        )
        store.create("pods", p)
        kl.handle_pod_event("ADDED", store.get("pods", "default", "burner"))
        kl.stats_publish_interval_s = 0.0  # test: defeat the 10 s throttle
        kl.housekeeping()  # first sample
        time.sleep(1.0)  # let the spinner accumulate real cpu time
        kl.housekeeping()  # second sample -> rate published
        pod = store.get("pods", "default", "burner")
        cpu_ann = pod.metadata.annotations.get(
            "metrics.kubernetes.io/cpu-usage"
        )
        assert cpu_ann and cpu_ann.endswith("m")
        assert int(cpu_ann[:-1]) > 100  # a spin loop busy >10% of a core
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/apis/metrics.k8s.io/v1beta1/"
            "namespaces/default/pods",
            timeout=10,
        ) as resp:
            doc = json.loads(resp.read())
        row = next(
            i for i in doc["items"] if i["metadata"]["name"] == "burner"
        )
        assert int(row["usage"]["cpu"][:-1]) > 100
        assert int(row["usage"]["memory"]) > 0
    finally:
        rt.kill_pod("default/burner")
        srv.shutdown()


def test_kubelet_pulls_images_before_start(tmp_path):
    """EnsureImageExists ordering: the kubelet pulls each container's
    image through the runtime's ImageService before the sandbox starts;
    IfNotPresent skips present images, Always re-pulls, Never never."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.kubelet.cri.wire import CRIServer, RemoteRuntime
    from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, make_node_object
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

    srv = CRIServer(FakeRuntime(_ip_alloc), str(tmp_path / "cri.sock"))
    srv.start()
    remote = RemoteRuntime(str(tmp_path / "cri.sock"))
    store = APIServer()
    store.create("nodes", make_node_object("n0"))
    kl = Kubelet(store, "n0", remote)
    try:
        pod = v1.Pod(
            metadata=v1.ObjectMeta(name="imgpod"),
            spec=v1.PodSpec(
                node_name="n0",
                containers=[
                    v1.Container(name="a", image="busybox:1.36"),
                    v1.Container(
                        name="b", image="secret:v1", image_pull_policy="Never"
                    ),
                ],
            ),
        )
        store.create("pods", pod)
        kl.handle_pod_event("ADDED", store.get("pods", "default", "imgpod"))
        imgs = remote.list_images()
        assert "busybox:1.36" in imgs
        assert "secret:v1" not in imgs  # Never means never
    finally:
        remote.close()
        srv.stop()


def test_exec_exit_code_propagates(tmp_path):
    """ExecSync carries the command's REAL exit status end-to-end
    (reference ExecSyncResponse.exit_code)."""
    from kubernetes_tpu_torch.kubelet.cri.wire import CRIServer, RemoteRuntime

    rt = ProcessRuntime(_ip_alloc, str(tmp_path / "pods"))
    srv = CRIServer(rt, str(tmp_path / "cri.sock"))
    srv.start()
    remote = RemoteRuntime(str(tmp_path / "cri.sock"))
    p = _pod_pr("ec", ["/bin/sleep", "30"])
    try:
        remote.run_pod(p)
        out, code = remote.exec_status(
            p.metadata.key, ["/bin/sh", "-c", "echo hi; exit 7"]
        )
        assert out.strip() == "hi" and code == 7
        out, code = remote.exec_status(p.metadata.key, ["/bin/true"])
        assert code == 0
    finally:
        remote.kill_pod(p.metadata.key)
        remote.close()
        srv.stop()


def test_args_only_container_runs_args(tmp_path):
    """Container(args=...) with no command: args become the argv (no
    image entrypoint exists to prepend) instead of silently running the
    pause sleep."""
    rt = ProcessRuntime(_ip_alloc, str(tmp_path))
    p = v1.Pod(
        metadata=v1.ObjectMeta(name="argsonly"),
        spec=v1.PodSpec(
            node_name="n0",
            containers=[v1.Container(name="m", args=["/bin/echo", "via-args"])],
        ),
    )
    rt.run_pod(p)
    assert _wait_phase(rt, p.metadata.key, v1.POD_SUCCEEDED)
    assert "via-args" in rt.logs(p.metadata.key)
