"""The port's kubeadm (kubernetes_tpu_torch/cmd/kubeadm.py, a port: its
init_cluster and standby_cluster take the device their Scheduler runs on)
held to the reference's own tests of it, every control plane at
device="cpu": init, token join and a pod run end to end, upgrade plan
and apply (tests/test_kubeadm.py); the conformance capstone, one secured
cluster with every controller (tests/test_conformance.py); the HA
standby that promotes a full control plane, and the fence on a stalled
primary (tests/test_replication.py:179, :239); the node authorizer on a
kubeadm cluster (tests/test_node_authorizer.py); the admission chain
kubeadm assembles, with the rest of tests/test_admission_breadth.py; and
the chaos scenarios of tests/test_chaos.py, slow in the reference and
here. Each section below is the reference file named in its heading
with its imports pointed at the port. Helpers that two reference files
define differently carry the file's tag.

Before them, what the port adds: without a card and without
device="cpu", init_cluster and standby_cluster raise before they bind a
port, dial the primary or write the data directory, and `kubeadm init`
and `kubeadm standby` map --platform cpu to device="cpu" and anything
else to the card. Tolerances: exact.
"""

import socket

import pytest

from kubernetes_tpu_torch.cmd import kubeadm


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_and_standby_raise_without_a_card_before_anything_starts(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: device=None runs on it")
    port = _free_port()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        kubeadm.init_cluster(str(tmp_path / "init"), port=port)
    assert not (tmp_path / "init").exists()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))  # nothing took the port
    # a listening socket stands in for the primary: it must see no dial
    primary = socket.create_server(("127.0.0.1", 0))
    primary.settimeout(0.5)
    try:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            kubeadm.standby_cluster(
                primary.getsockname()[:2], str(tmp_path / "standby"), insecure=True
            )
        with pytest.raises(socket.timeout):
            primary.accept()
    finally:
        primary.close()
    assert not (tmp_path / "standby").exists()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("verb", ["init", "standby"])
@pytest.mark.parametrize("platform,device", [([], None), (["--platform", "cpu"], "cpu"),
                                             (["--platform", "cuda"], None)])
def test_main_maps_platform_to_the_device(monkeypatch, tmp_path, verb, platform, device):
    seen = {}

    class Handle:
        server_url = "http://127.0.0.1:1"
        bootstrap_token = "t"
        replication_address = None

        def stop(self):
            seen["stopped"] = True

    def fake(*args, **kw):
        seen["device"] = kw["device"]
        return Handle()

    class Event:
        def wait(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(kubeadm, "init_cluster", fake)
    monkeypatch.setattr(kubeadm, "standby_cluster", fake)
    monkeypatch.setattr(kubeadm.threading, "Event", Event)
    argv = {"init": ["init", "--data-dir", str(tmp_path)],
            "standby": ["standby", "127.0.0.1:1", "--data-dir", str(tmp_path)]}[verb]
    assert kubeadm.main(argv + platform) == 0
    assert seen == {"device": device, "stopped": True}


def test_upgrade_plan_reads_the_ports_version_as_the_references():
    import kubernetes_tpu
    import kubernetes_tpu_torch

    assert kubernetes_tpu_torch.__version__ == kubernetes_tpu.__version__


# -- tests/test_kubeadm.py ---------------------------------------------
# kubeadm-lite bootstrap: init phases + token join + workload runs.
#
# Reference: cmd/kubeadm/app/cmd/phases/init (phased init, bootstrap-token
# join). The test boots a full secured control plane, joins a node over the
# bootstrap token, and runs a pod end to end through it.
import json
import os
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.apiserver.client import AuthRESTClient
from kubernetes_tpu_torch.cmd.kubeadm import ADMIN_CONF, init_cluster, join_node


def wait_until(fn, timeout=60.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def test_init_join_and_schedule(tmp_path):
    handle = init_cluster(str(tmp_path / "cluster"), port=0, device="cpu")
    pool = None
    try:
        # kubeconfig phase wrote usable admin credentials
        conf = json.load(open(os.path.join(handle.data_dir, ADMIN_CONF)))
        admin = AuthRESTClient(conf["server"], token=conf["token"])
        nodes, _ = admin.list("nodes")
        assert nodes == []

        # unauthenticated requests bounce (the cluster is secured)
        import urllib.error
        import urllib.request

        try:
            urllib.request.urlopen(f"{handle.server_url}/api/v1/nodes")
            raise AssertionError("anonymous request must be rejected")
        except urllib.error.HTTPError as e:
            assert e.code == 401

        # join a node with the bootstrap token; owned by the handle
        pool = join_node(
            handle.server_url, handle.bootstrap_token, "worker-0", handle=handle
        )
        assert pool in handle._joined
        assert wait_until(
            lambda: any(
                n.metadata.name == "worker-0" for n in admin.list("nodes")[0]
            )
        )

        # a workload scheduled by the in-process control plane runs on it
        admin.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name="boot-pod"),
                spec=v1.PodSpec(
                    containers=[v1.Container(requests={"cpu": "100m"})]
                ),
            ),
        )

        def running():
            p = admin.get("pods", "default", "boot-pod")
            return p.spec.node_name == "worker-0" and p.status.phase == "Running"

        assert wait_until(running, timeout=90), "pod must run on the joined node"
    finally:
        if pool is not None:
            pool.stop()
        handle.stop()


def test_upgrade_plan_and_apply(tmp_path):
    """kubeadm upgrade: plan reads the recorded cluster version, apply
    migrates it (refusing downgrades) — cmd/kubeadm/app/cmd/upgrade/."""
    import json as _json

    import pytest as _pytest

    from kubernetes_tpu_torch import __version__
    from kubernetes_tpu_torch.cmd.kubeadm import (
        init_cluster,
        upgrade_apply,
        upgrade_plan,
    )

    handle = init_cluster(str(tmp_path / "kubeadm"), controllers=[], device="cpu")
    try:
        plan = upgrade_plan(handle.store)
        assert plan["current"] == __version__
        assert plan["upgrade_available"] is False
        # apply to a newer version migrates the stored config
        res = upgrade_apply(handle.store, "v9.9.9")
        assert res == {"from": __version__, "to": "v9.9.9"}
        cm = handle.store.get("configmaps", "kube-system", "kubeadm-config")
        cfg = _json.loads(cm.data["ClusterConfiguration"])
        assert cfg["kubernetesVersion"] == "v9.9.9"
        # downgrades are refused
        with _pytest.raises(ValueError, match="downgrade"):
            upgrade_apply(handle.store, "v0.0.1")
        # idempotent re-apply
        assert upgrade_apply(handle.store, "v9.9.9")["to"] == "v9.9.9"
    finally:
        handle.stop()


# -- tests/test_conformance.py -----------------------------------------
# Conformance capstone: one secured cluster, every controller running,
# the major API machine flows exercised together (the e2e/conformance tier,
# reference test/conformance + test/e2e framework).
#
# Flow: kubeadm init (secured REST + WAL + scheduler + ALL controllers) →
# token join 3 worker nodes → Deployment rollout → Service with endpoints +
# slices + proxy resolution → quota enforcement → CRD create/use → drain a
# node under a PDB → everything converges.
import json
import time
import urllib.request

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.apiserver.client import AuthRESTClient
from kubernetes_tpu_torch.cmd.kubeadm import init_cluster, join_node


def wait_until_conf(fn, timeout=90.0, period=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def test_conformance_end_to_end(tmp_path):
    handle = init_cluster(str(tmp_path / "conf"), port=0, device="cpu")
    try:
        conf = json.load(
            open(f"{handle.data_dir}/admin.conf.json")
        )
        admin = AuthRESTClient(conf["server"], token=conf["token"])
        for i in range(3):
            join_node(
                handle.server_url,
                handle.bootstrap_token,
                f"worker-{i}",
                handle=handle,
            )
        assert wait_until_conf(lambda: len(admin.list("nodes")[0]) == 3)

        # -- node infra controllers: CIDРs + TTL annotations ---------------
        assert wait_until_conf(
            lambda: all(
                n.spec.pod_cidr and "node.alpha.kubernetes.io/ttl" in
                n.metadata.annotations
                for n in admin.list("nodes")[0]
            )
        ), "nodeipam + ttl controllers must dress every node"

        # -- workload: Deployment -> ReplicaSet -> running pods ------------
        admin.create(
            "deployments",
            v1.Deployment(
                metadata=v1.ObjectMeta(name="web"),
                spec=v1.DeploymentSpec(
                    replicas=4,
                    selector={"app": "web"},
                    template=v1.PodTemplateSpec(
                        metadata=v1.ObjectMeta(labels={"app": "web"}),
                        spec=v1.PodSpec(
                            containers=[
                                v1.Container(requests={"cpu": "100m"})
                            ]
                        ),
                    ),
                ),
            ),
        )

        def web_running():
            pods, _ = admin.list("pods")
            mine = [
                p
                for p in pods
                if p.metadata.labels.get("app") == "web"
                and p.status.phase == v1.POD_RUNNING
                and p.status.pod_ip
            ]
            return len(mine) == 4

        assert wait_until_conf(web_running), "deployment must converge to 4 running"

        # -- service dataplane: endpoints + slices + VIP resolution --------
        admin.create(
            "services",
            v1.Service(
                metadata=v1.ObjectMeta(name="web"),
                spec=v1.ServiceSpec(
                    selector={"app": "web"}, ports=[("http", 80)]
                ),
            ),
        )
        svc = admin.get("services", "default", "web")
        assert svc.spec.cluster_ip, "ClusterIP allocator must assign a VIP"

        def endpoints_ready():
            try:
                eps = admin.get("endpoints", "default", "web")
            except KeyError:
                return False
            n_ep = sum(len(s.addresses) for s in eps.subsets)
            slices, _ = admin.list("endpointslices")
            n_sl = sum(
                len(s.endpoints)
                for s in slices
                if s.metadata.labels.get("kubernetes.io/service-name") == "web"
            )
            return n_ep == 4 and n_sl == 4

        assert wait_until_conf(endpoints_ready), "endpoints + slices must publish"
        # one of the joined node agents resolves the VIP
        pool = handle._joined[0]
        assert wait_until_conf(
            lambda: pool.proxy.resolve(svc.spec.cluster_ip, "http") is not None
        ), "node proxy must route the service VIP"

        # -- quota: hard limit enforced through admission ------------------
        admin.create(
            "resourcequotas",
            v1.ResourceQuota(
                metadata=v1.ObjectMeta(name="cap"),
                spec=v1.ResourceQuotaSpec(hard={"pods": 5}),
            ),
        )

        def quota_tracked():
            q = admin.get("resourcequotas", "default", "cap")
            return q.status.used.get("pods") == 4

        assert wait_until_conf(quota_tracked), "quota status must track usage"
        # the FIFTH pod is within the hard pods=5 limit and must be admitted
        admin.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name="fifth"),
                spec=v1.PodSpec(containers=[v1.Container()]),
            ),
        )
        # the SIXTH trips the limit: a real boundary check, not just
        # "something was denied"
        denied = False
        try:
            admin.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name="sixth"),
                    spec=v1.PodSpec(containers=[v1.Container()]),
                ),
            )
        except urllib.error.HTTPError as e:
            denied = e.code == 403
        assert denied, "the pod over quota must be denied with 403"

        # -- CRDs: define + use a custom resource through the API ----------
        admin.create(
            "customresourcedefinitions",
            v1.CustomResourceDefinition(
                metadata=v1.ObjectMeta(name="gadgets.conf.io"),
                spec=v1.CustomResourceDefinitionSpec(
                    group="conf.io",
                    names=v1.CustomResourceDefinitionNames(
                        plural="gadgets", kind="Gadget"
                    ),
                ),
            ),
        )
        req = urllib.request.Request(
            f"{handle.server_url}/apis/conf.io/v1/namespaces/default/gadgets",
            data=json.dumps(
                {"kind": "Gadget", "metadata": {"name": "g1"}, "spec": {"x": 1}}
            ).encode(),
            method="POST",
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {conf['token']}",
            },
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 201

        # -- disruption: PDB + drain one node, workload re-converges -------
        admin.create(
            "poddisruptionbudgets",
            v1.PodDisruptionBudget(
                metadata=v1.ObjectMeta(name="web-pdb"),
                spec=v1.PodDisruptionBudgetSpec(
                    max_unavailable=1, selector={"app": "web"}
                ),
            ),
        )
        assert wait_until_conf(
            lambda: admin.get(
                "poddisruptionbudgets", "default", "web-pdb"
            ).status.disruptions_allowed
            >= 1
        ), "disruption controller must grant budget"
        from kubernetes_tpu_torch.cmd import kubectl

        rc = kubectl.main(
            [
                "--server",
                handle.server_url,
                # one item: a random token that starts with "-" would
                # otherwise read as an option
                f"--token={conf['token']}",
                "drain",
                "worker-0",
                "--timeout",
                "60",
            ]
        )
        assert rc == 0, "drain must succeed within the PDB budget"
        assert wait_until_conf(
            lambda: web_running()
            and all(
                p.spec.node_name != "worker-0"
                for p in admin.list("pods")[0]
                if p.metadata.labels.get("app") == "web"
            ),
            timeout=120,
        ), "drained workload must re-land on surviving nodes"
    finally:
        handle.stop()


# -- tests/test_replication.py -----------------------------------------
# Replicated API store: sync log shipping, lease failover, term fencing
# (runtime/replication.py; reference: etcd raft behind storage.Interface,
# staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:1).
import json
import socket
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
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


def test_kubeadm_ha_standby_promotes_full_control_plane(tmp_path):
    """kubeadm init --with-replication + standby: kill the primary, the
    standby promotes into a LIVE control plane (REST + scheduler +
    controllers on the replicated state) and schedules new work."""
    from kubernetes_tpu_torch.cmd.kubeadm import init_cluster, standby_cluster

    primary = init_cluster(
        str(tmp_path / "primary"), controllers=[], replication=True, device="cpu"
    )
    standby = None
    try:
        assert primary.replication_address is not None
        standby = standby_cluster(
            primary.replication_address,
            str(tmp_path / "standby"),
            lease_s=0.6,
            controllers=[],
            admin_token=primary.admin_token,
            device="cpu",
        )
        assert standby.follower.wait_synced(10.0)
        # state written before the failover...
        primary.store.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name="n0", namespace=""),
                status=v1.NodeStatus(
                    capacity={"cpu": "8", "memory": "16Gi", "pods": "110"},
                    allocatable={"cpu": "8", "memory": "16Gi", "pods": "110"},
                    conditions=[
                        v1.NodeCondition(type=v1.NODE_READY, status="True")
                    ],
                ),
            ),
        )
        deadline = time.monotonic() + 10.0
        while (
            standby.follower.rv < primary.store._rv
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        # the primary dies
        primary.stop()
        assert standby.wait_promoted(15.0), "standby never promoted"
        cluster = standby.cluster
        # ...survives, and NEW work schedules on the promoted plane
        cluster.store.create("pods", _pod_repl("post-failover"))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            p = cluster.store.get("pods", "default", "post-failover")
            if p.spec.node_name:
                break
            time.sleep(0.05)
        assert cluster.store.get(
            "pods", "default", "post-failover"
        ).spec.node_name == "n0"
    finally:
        if standby is not None:
            standby.stop()


def test_promotion_fences_stalled_primary(tmp_path):
    """Split-brain guard: promoting while the old primary is merely
    STALLED (alive, lease lapsed) fences it read-only via the higher-term
    hello, and the promoted plane keeps the security assembly."""
    from kubernetes_tpu_torch.client.apiserver import NotPrimary as _NP
    from kubernetes_tpu_torch.cmd.kubeadm import init_cluster, standby_cluster

    primary = init_cluster(
        str(tmp_path / "p"), controllers=[], replication=True, device="cpu"
    )
    standby = None
    try:
        standby = standby_cluster(
            primary.replication_address,
            str(tmp_path / "s"),
            lease_s=30.0,  # no auto-promotion: we promote explicitly
            controllers=[],
            admin_token=primary.admin_token,
            device="cpu",
        )
        assert standby.follower.wait_synced(10.0)
        cluster = standby.promote()
        assert cluster is not None and cluster.port > 0
        # the promoted REST facade still authenticates (401 without token)
        import urllib.request
        import urllib.error

        req = urllib.request.Request(
            f"http://127.0.0.1:{cluster.port}/api/v1/pods"
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5.0)
        assert ei.value.code == 401
        # the stalled old primary is fenced: writes refused
        deadline = time.monotonic() + 5.0
        while not primary.store.read_only and time.monotonic() < deadline:
            time.sleep(0.05)
        assert primary.store.read_only, "old primary not fenced"
        with pytest.raises(_NP):
            primary.store.create("pods", _pod_repl("split-brain"))
    finally:
        if standby is not None:
            standby.stop()
        primary.stop()


# -- tests/test_node_authorizer.py -------------------------------------
# Node authorizer (apiserver/nodeauth.py; reference
# plugin/pkg/auth/authorizer/node/node_authorizer.go): a kubelet identity
# is scoped to its own node's objects — kubelet A cannot bind/patch pods on
# node B (r4 verdict #8).
import json
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.cmd.kubeadm import init_cluster, join_node


def _req(port, path, token, method="GET", body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method,
        headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/json",
        },
    )
    with urllib.request.urlopen(req, timeout=10.0) as r:
        return r.status, json.loads(r.read() or b"{}")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nodeauth")
    handle = init_cluster(
        str(tmp / "c"),
        controllers=["bootstrapsigner", "csrapproving", "csrsigning"],
        device="cpu",
    )
    try:
        join_node(
            handle.server_url, handle.bootstrap_token, "node-a", handle=handle
        )
        join_node(
            handle.server_url, handle.bootstrap_token, "node-b", handle=handle
        )
        # node credentials signed by the CSR controllers
        creds = {}
        deadline = time.time() + 15.0
        while time.time() < deadline and len(creds) < 2:
            for n in ("node-a", "node-b"):
                try:
                    csr = handle.store.get(
                        "certificatesigningrequests", "", f"node-csr-{n}"
                    )
                    if csr.status.certificate:
                        creds[n] = csr.status.certificate
                except Exception:
                    pass
            time.sleep(0.1)
        assert len(creds) == 2, "node credentials never issued"
        # one pod bound to each node (created by the admin store directly)
        for n in ("node-a", "node-b"):
            handle.store.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"pod-{n}"),
                    spec=v1.PodSpec(
                        node_name=n,
                        containers=[v1.Container(requests={"cpu": "100m"})],
                        volumes=[
                            v1.Volume(name="s", secret=f"secret-{n}")
                        ],
                    ),
                ),
            )
            handle.store.create(
                "secrets",
                v1.Secret(
                    metadata=v1.ObjectMeta(name=f"secret-{n}"),
                    data={"k": b"v"},
                ),
            )
        yield handle, creds
    finally:
        handle.stop()


def test_kubelet_cannot_patch_pods_on_other_node(cluster):
    handle, creds = cluster
    # kubelet A updating ITS pod's status: allowed
    status, body = _req(
        handle.port,
        "/api/v1/namespaces/default/pods/pod-node-a",
        creds["node-a"],
    )
    assert status == 200
    body.setdefault("status", {})["message"] = "from-node-a"
    body["metadata"]["resourceVersion"] = 0  # unconditional PUT
    status, _ = _req(
        handle.port,
        "/api/v1/namespaces/default/pods/pod-node-a",
        creds["node-a"],
        method="PUT",
        body=body,
    )
    assert status == 200
    # kubelet A updating a pod bound to node B: 403
    status, other = _req(
        handle.port,
        "/api/v1/namespaces/default/pods/pod-node-b",
        creds["node-a"],
    )
    assert status == 200  # reads allowed (informer surface)
    other.setdefault("status", {})["message"] = "hijack"
    other["metadata"]["resourceVersion"] = 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(
            handle.port,
            "/api/v1/namespaces/default/pods/pod-node-b",
            creds["node-a"],
            method="PUT",
            body=other,
        )
    assert ei.value.code == 403


def test_kubelet_cannot_bind_pods(cluster):
    handle, creds = cluster
    handle.store.create(
        "pods",
        v1.Pod(
            metadata=v1.ObjectMeta(name="unbound"),
            spec=v1.PodSpec(containers=[v1.Container()]),
        ),
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(
            handle.port,
            "/api/v1/namespaces/default/pods/unbound/binding",
            creds["node-a"],
            method="POST",
            body={"target": {"name": "node-a"}, "metadata": {"name": "unbound"}},
        )
    assert ei.value.code == 403


def test_kubelet_cannot_write_other_node_object(cluster):
    handle, creds = cluster
    status, nb = _req(handle.port, "/api/v1/nodes/node-b", creds["node-a"])
    assert status == 200
    nb["metadata"]["resourceVersion"] = 0
    nb.setdefault("spec", {})["unschedulable"] = True
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(
            handle.port,
            "/api/v1/nodes/node-b",
            creds["node-a"],
            method="PUT",
            body=nb,
        )
    assert ei.value.code == 403


def test_kubelet_secret_access_follows_pod_graph(cluster):
    handle, creds = cluster
    # secret referenced by A's pod: readable by A
    status, _ = _req(
        handle.port,
        "/api/v1/namespaces/default/secrets/secret-node-a",
        creds["node-a"],
    )
    assert status == 200
    # secret referenced only by B's pod: 403 for A
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(
            handle.port,
            "/api/v1/namespaces/default/secrets/secret-node-b",
            creds["node-a"],
        )
    assert ei.value.code == 403


# -- tests/test_admission_breadth.py -----------------------------------
# Admission breadth: NodeRestriction, AlwaysPullImages, PodSecurityPolicy,
# quota scopes (apiserver/admission.py; reference plugin/pkg/admission/).
import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.apiserver.admission import (
    AlwaysPullImagesAdmission,
    NodeRestrictionAdmission,
    PodSecurityPolicyAdmission,
    pod_matches_scopes,
    request_user,
)
from kubernetes_tpu_torch.apiserver.auth import (
    AdmissionChain,
    AdmissionDenied,
    QuotaAdmission,
    UserInfo,
)
from kubernetes_tpu_torch.client.apiserver import APIServer


def _pod(name, node="", containers=None, host_network=False, adl=None):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(
            node_name=node,
            containers=containers or [v1.Container(requests={"cpu": "100m"})],
            host_network=host_network,
            active_deadline_seconds=adl,
        ),
    )


class _Ctx:
    """Set/restore the admission identity contextvar."""

    def __init__(self, user):
        self.user = user

    def __enter__(self):
        self.tok = request_user.set(self.user)

    def __exit__(self, *a):
        request_user.reset(self.tok)


def test_node_restriction_scopes_node_identity():
    plugin = NodeRestrictionAdmission()
    kubelet = UserInfo("system:node:n1", ("system:nodes",))
    # own node: allowed
    with _Ctx(kubelet):
        plugin.validate(
            "update", "nodes", v1.Node(metadata=v1.ObjectMeta(name="n1", namespace=""))
        )
        # another node: denied
        with pytest.raises(AdmissionDenied, match="cannot modify node"):
            plugin.validate(
                "update",
                "nodes",
                v1.Node(metadata=v1.ObjectMeta(name="n2", namespace="")),
            )
        # pod bound to itself: allowed; elsewhere: denied
        plugin.validate("update", "pods", _pod("p", node="n1"))
        with pytest.raises(AdmissionDenied, match="bound to"):
            plugin.validate("update", "pods", _pod("p", node="n2"))
        # unrelated resources: denied outright
        with pytest.raises(AdmissionDenied, match="may not"):
            plugin.validate("create", "secrets", None)
    # non-node users unrestricted
    with _Ctx(UserInfo("alice", ("system:authenticated",))):
        plugin.validate("update", "nodes", v1.Node(metadata=v1.ObjectMeta(name="n2")))
    # loopback (no identity): unrestricted
    plugin.validate("update", "nodes", v1.Node(metadata=v1.ObjectMeta(name="n2")))


def test_always_pull_images_forces_policy():
    store = APIServer()
    store.admit_hooks.append(
        AdmissionChain(mutating=[AlwaysPullImagesAdmission()])
    )
    store.create(
        "pods",
        _pod(
            "p",
            containers=[
                v1.Container(name="c1", image="private/img"),
                v1.Container(name="c2", image="other", image_pull_policy="Never"),
            ],
        ),
    )
    p = store.get("pods", "default", "p")
    assert all(c.image_pull_policy == "Always" for c in p.spec.containers)


def test_pod_security_policy_gates_capabilities():
    store = APIServer()
    plugin = PodSecurityPolicyAdmission(store)
    priv_pod = _pod(
        "priv",
        containers=[
            v1.Container(
                security_context=v1.SecurityContext(privileged=True)
            )
        ],
    )
    # no policies installed: gate open
    plugin.validate("create", "pods", priv_pod)
    # a restricted policy arms the gate
    store.create(
        "podsecuritypolicies",
        v1.PodSecurityPolicy(
            metadata=v1.ObjectMeta(name="restricted", namespace=""),
            spec=v1.PodSecurityPolicySpec(
                privileged=False, run_as_user_rule="MustRunAsNonRoot"
            ),
        ),
    )
    with pytest.raises(AdmissionDenied, match="privileged"):
        plugin.validate("create", "pods", priv_pod)
    with pytest.raises(AdmissionDenied, match="root"):
        plugin.validate(
            "create",
            "pods",
            _pod(
                "root",
                containers=[
                    v1.Container(
                        security_context=v1.SecurityContext(run_as_user=0)
                    )
                ],
            ),
        )
    with pytest.raises(AdmissionDenied, match="hostNetwork"):
        plugin.validate("create", "pods", _pod("hn", host_network=True))
    # plain pod passes; a privileged POLICY added later re-admits priv pods
    plugin.validate("create", "pods", _pod("plain"))
    store.create(
        "podsecuritypolicies",
        v1.PodSecurityPolicy(
            metadata=v1.ObjectMeta(name="privileged", namespace=""),
            spec=v1.PodSecurityPolicySpec(
                privileged=True, host_network=True
            ),
        ),
    )
    plugin.validate("create", "pods", priv_pod)


def test_quota_scopes_select_pods():
    be = _pod("be", containers=[v1.Container()])
    burst = _pod("burst")
    term = _pod("term", adl=60)
    assert pod_matches_scopes(be, ["BestEffort"])
    assert not pod_matches_scopes(burst, ["BestEffort"])
    assert pod_matches_scopes(burst, ["NotBestEffort"])
    assert pod_matches_scopes(term, ["Terminating"])
    assert not pod_matches_scopes(term, ["NotTerminating"])
    assert pod_matches_scopes(term, ["Terminating", "NotBestEffort"])


def test_scoped_quota_only_limits_matching_pods():
    store = APIServer()
    store.create(
        "resourcequotas",
        v1.ResourceQuota(
            metadata=v1.ObjectMeta(name="be-quota"),
            spec=v1.ResourceQuotaSpec(hard={"pods": 1}, scopes=["BestEffort"]),
        ),
    )
    store.admit_hooks.append(
        AdmissionChain(validating=[QuotaAdmission(store)])
    )
    # burstable pods bypass the BestEffort-scoped quota entirely
    store.create("pods", _pod("burst-1"))
    store.create("pods", _pod("burst-2"))
    # the first best-effort pod fits, the second trips the scope's limit
    store.create("pods", _pod("be-1", containers=[v1.Container()]))
    with pytest.raises(AdmissionDenied, match="exceeded quota"):
        store.create("pods", _pod("be-2", containers=[v1.Container()]))


def test_scoped_quota_status_tracks_matching_usage_only():
    from kubernetes_tpu_torch.controller.resourcequota import (
        compute_namespace_usage,
    )

    store = APIServer()
    store.create("pods", _pod("burst-1"))
    store.create("pods", _pod("be-1", containers=[v1.Container()]))
    assert compute_namespace_usage(store, "default")["pods"] == 2
    assert (
        compute_namespace_usage(store, "default", ["BestEffort"])["pods"] == 1
    )
    assert (
        compute_namespace_usage(store, "default", ["NotBestEffort"])["pods"]
        == 1
    )


def test_extended_resource_toleration_tpu_flow():
    """The TPU-shaped admission flow: chip-requesting pods automatically
    tolerate the accelerator pool's resource-keyed taint."""
    from kubernetes_tpu_torch.apiserver.admission import (
        ExtendedResourceTolerationAdmission,
    )

    plugin = ExtendedResourceTolerationAdmission()
    pod = _pod(
        "chips",
        containers=[v1.Container(requests={"tpu.dev/chip": "4", "cpu": "1"})],
    )
    plugin.mutate("create", "pods", pod)
    tols = {t.key: t for t in pod.spec.tolerations}
    assert "tpu.dev/chip" in tols
    assert tols["tpu.dev/chip"].operator == "Exists"
    assert tols["tpu.dev/chip"].effect == "NoSchedule"
    # idempotent; plain pods untouched
    plugin.mutate("create", "pods", pod)
    assert len([t for t in pod.spec.tolerations if t.key == "tpu.dev/chip"]) == 1
    plain = _pod("plain")
    plugin.mutate("create", "pods", plain)
    assert plain.spec.tolerations == []


def test_pod_node_selector_merges_and_conflicts():
    from kubernetes_tpu_torch.apiserver.admission import PodNodeSelectorAdmission

    store = APIServer()
    store.create(
        "namespaces",
        v1.Namespace(
            metadata=v1.ObjectMeta(
                name="default",
                namespace="",
                annotations={
                    PodNodeSelectorAdmission.ANNOTATION: "pool=gpu, tier=prod"
                },
            )
        ),
    )
    plugin = PodNodeSelectorAdmission(store)
    pod = _pod("p")
    plugin.mutate("create", "pods", pod)
    assert pod.spec.node_selector == {"pool": "gpu", "tier": "prod"}
    clash = _pod("q")
    clash.spec.node_selector = {"pool": "cpu"}
    with pytest.raises(AdmissionDenied, match="conflicts"):
        plugin.mutate("create", "pods", clash)


def test_pod_toleration_restriction_whitelist():
    import json as _json

    from kubernetes_tpu_torch.apiserver.admission import (
        PodTolerationRestrictionAdmission,
    )

    store = APIServer()
    store.create(
        "namespaces",
        v1.Namespace(
            metadata=v1.ObjectMeta(
                name="default",
                namespace="",
                annotations={
                    PodTolerationRestrictionAdmission.WHITELIST: _json.dumps(
                        [{"key": "dedicated"}]
                    )
                },
            )
        ),
    )
    plugin = PodTolerationRestrictionAdmission(store)
    ok = _pod("ok")
    ok.spec.tolerations = [v1.Toleration(key="dedicated", operator="Exists")]
    plugin.mutate("create", "pods", ok)
    bad = _pod("bad")
    bad.spec.tolerations = [v1.Toleration(key="other", operator="Exists")]
    with pytest.raises(AdmissionDenied, match="not whitelisted"):
        plugin.mutate("create", "pods", bad)
    # the PUT bypass is closed: adding a new non-whitelisted key on update
    store.create("pods", ok)
    upd = store.get("pods", "default", "ok")
    upd.spec.tolerations = list(upd.spec.tolerations) + [
        v1.Toleration(key="sneaky", operator="Exists")
    ]
    with pytest.raises(AdmissionDenied, match="not whitelisted"):
        plugin.mutate("update", "pods", upd)
    # but keys already on the stored pod (chain-injected at create) pass
    upd2 = store.get("pods", "default", "ok")
    plugin.mutate("update", "pods", upd2)


def test_pvc_resize_gate():
    from kubernetes_tpu_torch.apiserver.admission import PVCResizeAdmission

    store = APIServer()
    store.create(
        "storageclasses",
        v1.StorageClass(
            metadata=v1.ObjectMeta(name="fast", namespace=""),
            allow_volume_expansion=True,
        ),
    )
    store.create(
        "storageclasses",
        v1.StorageClass(metadata=v1.ObjectMeta(name="fixed", namespace="")),
    )
    pvc = v1.PersistentVolumeClaim(
        metadata=v1.ObjectMeta(name="c1"),
        spec=v1.PersistentVolumeClaimSpec(
            resources={"storage": "10Gi"}, storage_class_name="fast"
        ),
    )
    store.create("persistentvolumeclaims", pvc)
    plugin = PVCResizeAdmission(store)
    grown = store.get("persistentvolumeclaims", "default", "c1")
    grown.spec.resources = {"storage": "20Gi"}
    plugin.validate("update", "persistentvolumeclaims", grown)  # allowed
    shrunk = store.get("persistentvolumeclaims", "default", "c1")
    shrunk.spec.resources = {"storage": "5Gi"}
    with pytest.raises(AdmissionDenied, match="shrink"):
        plugin.validate("update", "persistentvolumeclaims", shrunk)
    # inexpandable class refuses growth
    pvc2 = v1.PersistentVolumeClaim(
        metadata=v1.ObjectMeta(name="c2"),
        spec=v1.PersistentVolumeClaimSpec(
            resources={"storage": "10Gi"}, storage_class_name="fixed"
        ),
    )
    store.create("persistentvolumeclaims", pvc2)
    g2 = store.get("persistentvolumeclaims", "default", "c2")
    g2.spec.resources = {"storage": "20Gi"}
    with pytest.raises(AdmissionDenied, match="does not allow"):
        plugin.validate("update", "persistentvolumeclaims", g2)


def test_whitelist_composes_with_chain_injected_tolerations(tmp_path):
    """Through the REAL assembled chain, reference-faithful ordering
    (AllOrderedPlugins, plugins.go:82-87): DefaultTolerationSeconds runs
    BEFORE the whitelist gate, so its not-ready/unreachable injections
    ARE judged (a strict whitelist must include them — the reference's
    merged-set VerifyAgainstWhitelist); ExtendedResourceToleration runs
    AFTER, so its chip toleration escapes the check."""
    import json as _json

    from kubernetes_tpu_torch.cmd.kubeadm import assemble_security
    from kubernetes_tpu_torch.apiserver.admission import (
        PodTolerationRestrictionAdmission,
    )

    store = APIServer()
    assemble_security(store, admin_token="t")
    # strict whitelist WITHOUT the chain-injected keys: plain pods are
    # denied, exactly like the reference
    store.create(
        "namespaces",
        v1.Namespace(
            metadata=v1.ObjectMeta(
                name="strict",
                namespace="",
                annotations={
                    PodTolerationRestrictionAdmission.WHITELIST: _json.dumps(
                        [{"key": "dedicated"}]
                    )
                },
            )
        ),
    )
    with pytest.raises(AdmissionDenied, match="not whitelisted"):
        store.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(name="plain", namespace="strict"),
                spec=v1.PodSpec(containers=[v1.Container()]),
            ),
        )
    # whitelist that includes the injected keys: admitted, and the
    # post-gate chip injection still lands un-judged
    store.create(
        "namespaces",
        v1.Namespace(
            metadata=v1.ObjectMeta(
                name="wl",
                namespace="",
                annotations={
                    PodTolerationRestrictionAdmission.WHITELIST: _json.dumps(
                        [
                            {"key": "dedicated"},
                            {"key": "node.kubernetes.io/not-ready"},
                            {"key": "node.kubernetes.io/unreachable"},
                        ]
                    )
                },
            )
        ),
    )
    p = v1.Pod(
        metadata=v1.ObjectMeta(name="plain", namespace="wl"),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"tpu.dev/chip": "1"})]
        ),
    )
    store.create("pods", p)
    stored = store.get("pods", "wl", "plain")
    keys = {t.key for t in stored.spec.tolerations}
    assert "tpu.dev/chip" in keys  # injector ran after the gate, unjudged
    # a USER-supplied non-whitelisted toleration is still denied
    q = v1.Pod(
        metadata=v1.ObjectMeta(name="bad", namespace="wl"),
        spec=v1.PodSpec(
            containers=[v1.Container()],
            tolerations=[v1.Toleration(key="other", operator="Exists")],
        ),
    )
    with pytest.raises(AdmissionDenied, match="not whitelisted"):
        store.create("pods", q)


# ---------------------------------------------------------------------------
# round-5 breadth: RuntimeClass, TaintNodesByCondition,
# StorageObjectInUseProtection, CertificateSubjectRestriction, chain order
# ---------------------------------------------------------------------------


def test_runtime_class_merges_overhead_and_scheduling():
    from kubernetes_tpu_torch.apiserver.admission import RuntimeClassAdmission

    server = APIServer()
    server.create(
        "runtimeclasses",
        v1.RuntimeClass(
            metadata=v1.ObjectMeta(name="gvisor", namespace=""),
            handler="runsc",
            overhead={"cpu": "250m", "memory": "120Mi"},
            scheduling=v1.RuntimeClassScheduling(
                node_selector={"sandbox": "gvisor"},
                tolerations=[
                    v1.Toleration(key="sandbox", operator="Exists")
                ],
            ),
        ),
    )
    plugin = RuntimeClassAdmission(server)
    pod = _pod("p")
    pod.spec.runtime_class_name = "gvisor"
    plugin.mutate("create", "pods", pod)
    assert pod.spec.overhead == {"cpu": "250m", "memory": "120Mi"}
    assert pod.spec.node_selector["sandbox"] == "gvisor"
    assert any(t.key == "sandbox" for t in pod.spec.tolerations)

    # unknown class: denied
    bad = _pod("q")
    bad.spec.runtime_class_name = "nope"
    with pytest.raises(AdmissionDenied):
        plugin.mutate("create", "pods", bad)

    # conflicting user-supplied overhead: denied
    conflict = _pod("r")
    conflict.spec.runtime_class_name = "gvisor"
    conflict.spec.overhead = {"cpu": "1"}
    with pytest.raises(AdmissionDenied):
        plugin.mutate("create", "pods", conflict)

    # conflicting node selector: denied
    sel = _pod("s")
    sel.spec.runtime_class_name = "gvisor"
    sel.spec.node_selector = {"sandbox": "kata"}
    with pytest.raises(AdmissionDenied):
        plugin.mutate("create", "pods", sel)


def test_taint_nodes_by_condition_and_lifecycle_lift():
    from kubernetes_tpu_torch.apiserver.admission import (
        TaintNodesByConditionAdmission,
    )
    from kubernetes_tpu_torch.controller.nodelifecycle import (
        TAINT_NOT_READY,
        NodeLifecycleController,
    )

    plugin = TaintNodesByConditionAdmission()
    # a statusless registration gets the not-ready taint
    bare = v1.Node(metadata=v1.ObjectMeta(name="new", namespace=""))
    plugin.mutate("create", "nodes", bare)
    assert any(t.key == TAINT_NOT_READY for t in bare.spec.taints)
    # a registration already reporting Ready does not
    ready = v1.Node(
        metadata=v1.ObjectMeta(name="ready", namespace=""),
        status=v1.NodeStatus(
            conditions=[v1.NodeCondition(type=v1.NODE_READY, status="True")]
        ),
    )
    plugin.mutate("create", "nodes", ready)
    assert not ready.spec.taints

    # the lifecycle controller lifts the taint once the node is healthy
    server = APIServer()
    server.create("nodes", bare)
    ctrl = NodeLifecycleController(server)
    ctrl._monitor_once()  # no lease -> healthy -> taint lifted
    node = server.get("nodes", "", "new")
    assert not any(t.key == TAINT_NOT_READY for t in node.spec.taints)


def test_storage_object_in_use_protection_finalizers():
    from kubernetes_tpu_torch.apiserver.admission import (
        StorageObjectInUseProtectionAdmission,
    )

    plugin = StorageObjectInUseProtectionAdmission()
    pvc = v1.PersistentVolumeClaim(metadata=v1.ObjectMeta(name="c"))
    plugin.mutate("create", "persistentvolumeclaims", pvc)
    assert "kubernetes.io/pvc-protection" in pvc.metadata.finalizers
    pv = v1.PersistentVolume(metadata=v1.ObjectMeta(name="v", namespace=""))
    plugin.mutate("create", "persistentvolumes", pv)
    assert "kubernetes.io/pv-protection" in pv.metadata.finalizers


def test_certificate_subject_restriction_blocks_masters():
    from kubernetes_tpu_torch.apiserver.admission import (
        CertificateSubjectRestrictionAdmission,
    )

    plugin = CertificateSubjectRestrictionAdmission()
    csr = v1.CertificateSigningRequest(
        metadata=v1.ObjectMeta(name="evil", namespace=""),
        spec=v1.CertificateSigningRequestSpec(
            username="mallory",
            groups=["system:masters"],
            signer_name="kubernetes.io/kube-apiserver-client",
        ),
    )
    with pytest.raises(AdmissionDenied):
        plugin.validate("create", "certificatesigningrequests", csr)
    # other signers are unaffected
    csr.spec.signer_name = "kubernetes.io/kube-apiserver-client-kubelet"
    plugin.validate("create", "certificatesigningrequests", csr)


def test_kubeadm_chain_matches_reference_recommended_order(tmp_path):
    """The kubeadm chain's relative plugin order must match the
    reference's recommended order (pkg/kubeapiserver/options/plugins.go
    AllOrderedPlugins): mutators before validators, and within the
    mutating phase the documented sequence."""
    from kubernetes_tpu_torch.apiserver.auth import AdmissionChain as AC
    from kubernetes_tpu_torch.cmd.kubeadm import init_cluster

    cluster = init_cluster(str(tmp_path / "c"), controllers=[], device="cpu")
    try:
        chain = next(
            h for h in cluster.store.admit_hooks if isinstance(h, AC)
        )
        mut = [p.name for p in chain.mutating]
        val = [p.name for p in chain.validating]
        # reference AllOrderedPlugins relative order
        # (pkg/kubeapiserver/options/plugins.go:64, subset present here):
        # LimitRanger(73) < ServiceAccount(74) < TaintNodesByCondition(76)
        # < PodNodeSelector(80) < Priority(81) <
        # DefaultTolerationSeconds(82) < PodTolerationRestriction(83) <
        # ExtendedResourceToleration(87) < DefaultStorageClass(89) <
        # StorageObjectInUseProtection(90) < RuntimeClass(93) <
        # DefaultIngressClass(101) < MutatingAdmissionWebhook(102)
        expected_mut_order = [
            "LimitRanger",
            "ServiceAccount",
            "TaintNodesByCondition",
            "PodNodeSelector",
            "Priority",
            "DefaultTolerationSeconds",
            "PodTolerationRestriction",
            "ExtendedResourceToleration",
            "DefaultStorageClass",
            "StorageObjectInUseProtection",
            "RuntimeClass",
            "DefaultIngressClass",
            "MutatingAdmissionWebhook",
        ]
        assert mut == expected_mut_order, mut
        # NamespaceLifecycle(68) < LimitRanger(73) < NodeRestriction(75) <
        # PodSecurityPolicy(79) < PersistentVolumeClaimResize(92) <
        # CertificateApproval(94) < CertificateSigning(95) <
        # CertificateSubjectRestriction(96) <
        # ValidatingAdmissionWebhook(103) < ResourceQuota(104)
        expected_val_order = [
            "NamespaceLifecycle",
            "LimitRanger",
            "NodeRestriction",
            "PodSecurityPolicy",
            "PersistentVolumeClaimResize",
            "CertificateApproval",
            "CertificateSigning",
            "CertificateSubjectRestriction",
            "ValidatingAdmissionWebhook",
            "ResourceQuota",
        ]
        assert val == expected_val_order, val
        # 23 named plugins chained (LimitRanger appears in both phases)
        assert len(set(mut) | set(val)) >= 21
    finally:
        cluster.stop()


# -- tests/test_chaos.py -----------------------------------------------
# Chaos tier: kill control-plane components mid-burst and assert the
# cluster converges after recovery.
#
# Reference stance: test/e2e/chaosmonkey/chaosmonkey.go:22-48 (register a
# Disruption and Tests that must hold across it) + the crash-only fault model
# (components are stateless against the store; restart = re-list + rebuild).
# Here the disruption is a REAL mid-burst kill: the scheduler is stopped with
# a wave batch potentially in flight and binds half-done, the process state
# dropped, and a fresh control plane recovers from the WAL.
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.kubelet.kubelet import NodeAgentPool
from kubernetes_tpu_torch.runtime.wal import WriteAheadLog
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler


def wait_until_chaos(fn, timeout=60.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def make_pod(name, cpu="100m"):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )


def _bound_count(server):
    return server.count("pods", lambda p: bool(p.spec.node_name))


@pytest.mark.slow
def test_kill_scheduler_mid_burst_recovery_converges(tmp_path):
    """Burst 200 pods; kill scheduler+kubelets after ~a third have bound;
    recover the store from the WAL, start a FRESH control plane, and
    require full convergence: every pod bound exactly once, each node's
    commitments consistent."""
    path = str(tmp_path / "chaos")
    # fsync=False: this test kills the PROCESS state, not the machine —
    # OS-flushed records survive (and the suite stays fast)
    server = APIServer(wal=WriteAheadLog(path, fsync=False))
    pool = NodeAgentPool(server, housekeeping_interval=0.1)
    for i in range(8):
        pool.add_node(f"node-{i}")
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    pool.start()
    sched.start()
    n_pods = 200
    try:
        for i in range(n_pods):
            server.create("pods", make_pod(f"burst-{i}"))
        # let part of the burst land, then pull the plug mid-flight
        assert wait_until_chaos(lambda: _bound_count(server) >= n_pods // 3)
    finally:
        sched.stop()  # the in-flight wave batch dies with the process
        pool.stop()
    bound_at_crash = _bound_count(server)
    # NOTE: no upper-bound assert — a fast scheduler may finish the whole
    # burst before the plug is pulled; the invariant under test is that
    # recovery converges from WHATEVER state the kill left on disk

    # ---- recover on a fresh control plane --------------------------------
    server2 = APIServer.recover(path)
    assert _bound_count(server2) == bound_at_crash, (
        "recovered store must replay exactly the acknowledged binds"
    )
    pool2 = NodeAgentPool(server2, housekeeping_interval=0.1)
    for i in range(8):
        pool2.add_node(f"node-{i}", register=False)
    sched2 = Scheduler(server2, KubeSchedulerConfiguration(), device="cpu")
    pool2.start()
    sched2.start()
    try:
        assert wait_until_chaos(
            lambda: _bound_count(server2) == n_pods, timeout=120
        ), f"only {_bound_count(server2)}/{n_pods} pods bound after recovery"
        # consistency: every pod exactly one node; per-node pod count sane
        pods, _ = server2.list("pods")
        per_node = {}
        for p in pods:
            assert p.spec.node_name, p.metadata.name
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
        assert sum(per_node.values()) == n_pods
        # all burst pods eventually Running via the recovered kubelets
        assert wait_until_chaos(
            lambda: server2.count(
                "pods", lambda p: p.status.phase == v1.POD_RUNNING
            )
            == n_pods,
            timeout=60,
        )
    finally:
        sched2.stop()
        pool2.stop()


@pytest.mark.slow
def test_kill_kubelet_node_evicts_and_reschedules(tmp_path):
    """Kill one kubelet (node stops heartbeating): nodelifecycle must taint/
    evict, and the workload controller must replace the pods elsewhere —
    the node-failure chaos path."""
    from kubernetes_tpu_torch.controller.nodelifecycle import NodeLifecycleController
    from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
    from kubernetes_tpu_torch.kubemark.hollow_node import HollowCluster

    server = APIServer()
    cluster = HollowCluster(server, num_nodes=3, heartbeat_interval=0.2)
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    rs = ReplicaSetController(server)
    nlc = NodeLifecycleController(
        server,
        node_monitor_period=0.2,
        node_monitor_grace_period=1.0,
        pod_eviction_timeout=0.5,
    )
    cluster.start()
    sched.start()
    rs.start()
    nlc.start()
    try:
        server.create(
            "replicasets",
            v1.ReplicaSet(
                metadata=v1.ObjectMeta(name="web"),
                spec=v1.ReplicaSetSpec(
                    replicas=6,
                    selector={"app": "web"},
                    template=v1.PodTemplateSpec(
                        metadata=v1.ObjectMeta(labels={"app": "web"}),
                        spec=v1.PodSpec(
                            containers=[v1.Container(requests={"cpu": "100m"})]
                        ),
                    ),
                ),
            ),
        )
        assert wait_until_chaos(
            lambda: server.count(
                "pods",
                lambda p: bool(p.spec.node_name)
                and p.metadata.labels.get("app") == "web",
            )
            == 6,
            timeout=60,
        )
        cluster.kill_node("hollow-node-0")
        # convergence: 6 replicas bound on the surviving nodes
        def healthy():
            pods, _ = server.list("pods")
            live = [
                p
                for p in pods
                if p.metadata.labels.get("app") == "web"
                and p.metadata.deletion_timestamp is None
                and p.spec.node_name
                and p.spec.node_name != "hollow-node-0"
            ]
            return len(live) >= 6

        assert wait_until_chaos(healthy, timeout=90), (
            "replicas must re-land on surviving nodes after node death"
        )
    finally:
        nlc.stop()
        rs.stop()
        sched.stop()
        cluster.stop()


@pytest.mark.slow
def test_upgrade_apply_mid_burst_does_not_disrupt(tmp_path):
    """The chaosmonkey upgrade-suite shape (test/e2e/chaosmonkey): run an
    upgrade WHILE a scheduling burst is in flight — every pod still lands
    and the cluster version migrates."""
    from kubernetes_tpu_torch.cmd.kubeadm import init_cluster, upgrade_apply

    handle = init_cluster(str(tmp_path / "up"), controllers=[], device="cpu")
    try:
        store = handle.store
        for i in range(10):
            store.create(
                "nodes",
                v1.Node(
                    metadata=v1.ObjectMeta(name=f"n{i}", namespace=""),
                    status=v1.NodeStatus(
                        capacity={"cpu": "16", "memory": "64Gi", "pods": "110"},
                        allocatable={
                            "cpu": "16", "memory": "64Gi", "pods": "110"
                        },
                    ),
                ),
            )
        n_pods = 120
        for i in range(n_pods // 2):
            store.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"a{i}"),
                    spec=v1.PodSpec(
                        containers=[v1.Container(requests={"cpu": "100m"})]
                    ),
                ),
            )
        # the disruption, mid-burst
        res = upgrade_apply(store, "v9.9.9")
        assert res["to"] == "v9.9.9"
        for i in range(n_pods // 2):
            store.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"b{i}"),
                    spec=v1.PodSpec(
                        containers=[v1.Container(requests={"cpu": "100m"})]
                    ),
                ),
            )
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            bound = store.count("pods", lambda p: bool(p.spec.node_name))
            if bound >= n_pods:
                break
            time.sleep(0.1)
        assert bound >= n_pods, f"only {bound}/{n_pods} scheduled across upgrade"
        import json as _json

        cm = store.get("configmaps", "kube-system", "kubeadm-config")
        assert (
            _json.loads(cm.data["ClusterConfiguration"])["kubernetesVersion"]
            == "v9.9.9"
        )
    finally:
        handle.stop()
