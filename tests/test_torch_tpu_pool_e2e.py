"""tests/test_tpu_pool_e2e.py on the port: the accelerator-pool flow end
to end. Tainted accelerator nodes advertise an extended resource through
device plugins (DevicePluginStub -> DeviceManager -> the kubelet's node
status), ExtendedResourceTolerationAdmission injects the toleration into
chip-requesting pods, the Scheduler's device kernel packs them onto the
pool (the extended-resource fit and the taints are kernel-side), and the
device manager hands out topology-aligned devices. The same cluster runs
under the reference's Scheduler and the port's (device="cpu"); the
outcomes must be the same: capacities, where each kind of pod lands, the
pool's per-node packing, the aligned allocations and the overflow pod
left pending. Which of two equal nodes a pod takes is the tie noise's
choice, so placements are compared per node count, not per pod."""

import importlib
import time
from contextlib import contextmanager

from test_torch_coscheduling import _reference_metrics_left_as_found  # noqa: F401

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
CHIP = "tpu.dev/chip"


class _Pkg:
    def __init__(self, pkg):
        self.pkg = pkg
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.v1 = mod("api.objects")
        self.APIServer = mod("client.apiserver").APIServer
        self.Admission = mod("apiserver.admission").ExtendedResourceTolerationAdmission
        self.AdmissionChain = mod("apiserver.auth").AdmissionChain
        dm = mod("kubelet.devicemanager")
        self.Device, self.DeviceManager, self.DevicePluginStub = (
            dm.Device, dm.DeviceManager, dm.DevicePluginStub)
        kubelet = mod("kubelet.kubelet")
        self.Kubelet, self.make_node_object = kubelet.Kubelet, kubelet.make_node_object
        self.FakeRuntime = mod("kubelet.runtime").FakeRuntime
        self.fake_pod_ip = mod("kubemark.hollow_node")._fake_pod_ip
        self.Scheduler = mod("scheduler").Scheduler
        self.Config = mod("scheduler.config").KubeSchedulerConfiguration

    def chip_pod(self, name, n):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.PodSpec(containers=[v1.Container(requests={CHIP: str(n), "cpu": "100m"})]),
        )


@contextmanager
def cluster(p, tmp):
    """2 ordinary nodes and 2 accelerator nodes tainted chip-only, each
    with 4 devices in 2 topology domains behind a device plugin."""
    v1 = p.v1
    server = p.APIServer()
    server.admit_hooks.append(p.AdmissionChain(mutating=[p.Admission()]))
    for i in range(2):
        server.create("nodes", p.make_node_object(f"cpu-{i}"))
    kubelets, managers, stubs = {}, [], []
    sched = None
    try:
        for i in range(2):
            name = f"tpu-{i}"
            node = p.make_node_object(name)
            node.spec.taints = [v1.Taint(CHIP, "", v1.TAINT_NO_SCHEDULE)]
            server.create("nodes", node)
            dm = p.DeviceManager(str(tmp / f"{name}.sock"),
                                 checkpoint_path=str(tmp / f"{name}.state"))
            dm.start()
            managers.append(dm)
            stub = p.DevicePluginStub(dm.socket_path, CHIP, [
                p.Device("d0", topology=0), p.Device("d1", topology=0),
                p.Device("d2", topology=1), p.Device("d3", topology=1),
            ])
            stub.start()
            stubs.append(stub)
            kl = p.Kubelet(server, name, p.FakeRuntime(p.fake_pod_ip), device_manager=dm)
            deadline = time.monotonic() + 5.0
            while CHIP not in dm.capacities() and time.monotonic() < deadline:
                time.sleep(0.01)
            kl.sync_device_capacity()
            kubelets[name] = kl
        cfg = p.Config(use_mesh=False)
        sched = (p.Scheduler(server, cfg, device="cpu") if p.pkg == "kubernetes_tpu_torch"
                 else p.Scheduler(server, cfg))
        sched.start()
        yield server, kubelets
    finally:
        if sched is not None:
            sched.stop()
        for s in stubs:
            s.stop()
        for dm in managers:
            dm.stop()


def _wait_bound(server, name, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        p = server.get("pods", "default", name)
        if p.spec.node_name:
            return p
        time.sleep(0.05)
    raise TimeoutError(f"{name} never scheduled")


def _pool_flow(p, tmp):
    v1 = p.v1
    tmp.mkdir()
    with cluster(p, tmp) as (server, kubelets):
        capacity = {n: server.get("nodes", "", n).status.capacity[CHIP]
                    for n in ("tpu-0", "tpu-1")}
        # a plain pod stays off the tainted pool
        server.create("pods", v1.Pod(
            metadata=v1.ObjectMeta(name="plain"),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "1"})]),
        ))
        plain = _wait_bound(server, "plain").spec.node_name
        # chip pods: admission injects the toleration, the kernel places
        # them on the pool, the device manager allocates aligned devices
        for i in range(4):
            server.create("pods", p.chip_pod(f"chip-{i}", 2))
        per_node, allocs, tolerated = {}, {}, []
        for i in range(4):
            pod = _wait_bound(server, f"chip-{i}")
            node = pod.spec.node_name
            tolerated.append(any(t.key == CHIP for t in pod.spec.tolerations))
            per_node[node] = per_node.get(node, 0) + 1
            kl = kubelets.get(node)
            if kl is not None:
                kl.handle_pod_event("ADDED", pod)
                ids = sorted(kl.device_manager.allocations(pod.metadata.key)[CHIP])
                allocs.setdefault(node, []).append(ids)
        # a 5th chip pod has nowhere to go (the pool is full): it stays pending
        server.create("pods", p.chip_pod("overflow", 2))
        time.sleep(1.5)
        overflow = server.get("pods", "default", "overflow").spec.node_name
    return {
        "capacity": capacity,
        "plain_on": plain.split("-")[0],
        "tolerated": tolerated,
        "per_node": dict(sorted(per_node.items())),
        "allocs": {n: sorted(a) for n, a in sorted(allocs.items())},
        "overflow": overflow,
    }


def test_chip_pods_land_on_the_pool_with_aligned_devices(tmp_path):
    # short directory names: a device plugin's socket path must fit
    # AF_UNIX's 108 bytes under the xdist worker's basetemp
    ref, port = (_pool_flow(_Pkg(pkg), tmp_path / tag) for pkg, tag in zip(PKGS, "rp"))
    assert port == ref, (ref, port)
    assert port["capacity"] == {"tpu-0": 4, "tpu-1": 4}
    assert port["plain_on"] == "cpu"
    assert port["tolerated"] == [True] * 4
    # 4 pods x 2 chips = both pool nodes full, each allocation in one domain
    assert port["per_node"] == {"tpu-0": 2, "tpu-1": 2}
    assert port["allocs"] == {n: [["d0", "d1"], ["d2", "d3"]] for n in ("tpu-0", "tpu-1")}
    assert port["overflow"] == ""
