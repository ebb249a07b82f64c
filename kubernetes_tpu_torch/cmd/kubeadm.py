"""kubeadm-lite: phased cluster bootstrap (port).

PyTorch port of ``kubernetes_tpu/cmd/kubeadm.py``: the same phases, trust
assembly, standby, join, discovery and upgrade. What changed:

* ``init_cluster(..., device=None)`` and ``standby_cluster(...,
  device=None)`` resolve ``device`` before anything starts and hand it to
  the control plane's ``Scheduler``: None is the CUDA card (raises without
  one), ``"cpu"`` runs it on the CPU.
* ``--platform cpu`` on ``init`` and ``standby`` means ``device="cpu"``;
  any other value, or none, means the card.
* A standby's Scheduler is built inside ``on_promote``, on the follower's
  thread, so its first launch happens there. The kernels are built once
  per source hash into ``build/kernels/`` and loaded on first use, so a
  process that launched them before promotion loads nothing new then.

Every other definition is the reference's (``tests/test_torch_copies.py``).
The reference's notes follow.

Reference: cmd/kubeadm/app/cmd/phases/init/ — `kubeadm init` runs named
phases (certs → kubeconfig → control-plane → bootstrap-token → addons) and
prints a join command; `kubeadm join` registers a node using the bootstrap
token. Here the control plane is the in-process stack (store+WAL → REST
facade with authn/RBAC/admission → scheduler → controller-manager), the
"certs" phase is the bearer-token trust root (no x509 in this build), and
join starts a kubelet against the API over its token.

Programmatic surface (used by tests and the CLI):
    handle = init_cluster(data_dir, port)   # phases, returns running stack
    join_node(server_url, token, node_name) # register + run a node agent
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..device import DeviceLike, resolve_device

logger = logging.getLogger("kubernetes_tpu.cmd.kubeadm")

BOOTSTRAP_TOKEN_SECRET = "bootstrap-token"
ADMIN_CONF = "admin.conf.json"


@dataclass
class ClusterHandle:
    store: object
    http_server: object
    port: int
    scheduler: object
    controller_manager: object
    admin_token: str
    bootstrap_token: str
    data_dir: str
    _joined: List[object] = field(default_factory=list)
    replication: object = None  # ReplicationListener when HA is enabled

    @property
    def server_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def replication_address(self):
        return self.replication.address if self.replication else None

    def stop(self) -> None:
        for pool in self._joined:
            pool.stop()
        self.controller_manager.stop()
        self.scheduler.stop()
        if self.replication is not None:
            self.replication.close()
        self.http_server.shutdown()
        audit = getattr(self.http_server, "audit", None)
        if audit is not None:
            audit.stop()  # drain + close the audit writer


def assemble_security(store, admin_token=None, bootstrap_token=None):
    """The apiserver's trust + admission assembly, shared by init and the
    standby's promotion (a failover must NOT downgrade the cluster to an
    unauthenticated, admission-free API server). Returns (authn, authz)
    and installs the admit-hook chain on the store."""
    from ..apiserver.admission import (
        CertificateApprovalAdmission,
        CertificateSigningAdmission,
        CertificateSubjectRestrictionAdmission,
        DefaultIngressClassAdmission,
        ExtendedResourceTolerationAdmission,
        NodeRestrictionAdmission,
        PodNodeSelectorAdmission,
        PodSecurityPolicyAdmission,
        PodTolerationRestrictionAdmission,
        PVCResizeAdmission,
        RuntimeClassAdmission,
        StorageObjectInUseProtectionAdmission,
        TaintNodesByConditionAdmission,
    )
    from ..apiserver.auth import (
        MASTERS_GROUP,
        AdmissionChain,
        DefaultStorageClassAdmission,
        DefaultTolerationSecondsAdmission,
        LimitRangerAdmission,
        NamespaceLifecycleAdmission,
        PriorityAdmission,
        QuotaAdmission,
        RBACAuthorizer,
        ServiceAccountAdmission,
        TokenAuthenticator,
        make_rule,
    )
    from ..apiserver.webhook import (
        MutatingWebhookAdmission,
        ValidatingWebhookAdmission,
    )
    from ..proxy import ClusterIPAllocator

    authn = TokenAuthenticator(server=store, allow_anonymous=False)
    if admin_token:
        authn.add_token(
            admin_token, "kubernetes-admin", groups=(MASTERS_GROUP,)
        )
    if bootstrap_token:
        authn.add_token(
            bootstrap_token, "system:bootstrap", groups=("system:bootstrappers",)
        )
    # server-backed: ClusterRole/ClusterRoleBinding objects created via the
    # API feed authorization alongside the programmatic bootstrap policy;
    # node identities (system:node:*) route through the node authorizer's
    # decision table instead (plugin/pkg/auth/authorizer/node)
    from ..apiserver.nodeauth import NodeAwareAuthorizer

    authz = NodeAwareAuthorizer(RBACAuthorizer(server=store), store)
    # bootstrappers run node agents: register + heartbeat, sync pods, and
    # feed the node-side service dataplane (the system:node role shape)
    authz.bind(
        "system:bootstrappers",
        make_rule(["create", "update", "get"], ["nodes", "leases"]),
    )
    authz.bind(
        "system:bootstrappers",
        make_rule(["get", "list", "watch", "update"], ["pods"]),
    )
    authz.bind(
        "system:bootstrappers",
        make_rule(["get", "list", "watch"], ["services", "endpoints"]),
    )
    # token discovery: joining nodes read the signed cluster-info document
    authz.bind(
        "system:bootstrappers", make_rule(["get"], ["configmaps"], ["kube-public"])
    )
    # TLS bootstrap: file + poll the kubelet CSR (the reference's
    # system:node-bootstrapper ClusterRole)
    authz.bind(
        "system:bootstrappers",
        make_rule(["create", "get"], ["certificatesigningrequests"]),
    )
    store.admit_hooks.append(ClusterIPAllocator())
    # mutators first, then validators (admission/chain.go ordering); the
    # per-phase sequence follows the reference's recommended order
    # (pkg/kubeapiserver/options/plugins.go:64 AllOrderedPlugins). Notable
    # reference-faithful consequences: DefaultTolerationSeconds' injected
    # tolerations ARE subject to a namespace whitelist (it precedes
    # PodTolerationRestriction) while ExtendedResourceToleration's are
    # not (it follows); ResourceQuota runs last, after the webhooks.
    store.admit_hooks.append(
        AdmissionChain(
            mutating=[
                LimitRangerAdmission(store),
                ServiceAccountAdmission(),
                TaintNodesByConditionAdmission(),
                PodNodeSelectorAdmission(store),
                PriorityAdmission(store),
                DefaultTolerationSecondsAdmission(),
                PodTolerationRestrictionAdmission(store),
                ExtendedResourceTolerationAdmission(),
                DefaultStorageClassAdmission(store),
                StorageObjectInUseProtectionAdmission(),
                RuntimeClassAdmission(store),
                DefaultIngressClassAdmission(store),
                MutatingWebhookAdmission(store),
            ],
            validating=[
                NamespaceLifecycleAdmission(store),
                LimitRangerAdmission(store),
                NodeRestrictionAdmission(),
                PodSecurityPolicyAdmission(store),
                PVCResizeAdmission(store),
                CertificateApprovalAdmission(authz, store),
                CertificateSigningAdmission(authz, store),
                CertificateSubjectRestrictionAdmission(),
                ValidatingWebhookAdmission(store),
                QuotaAdmission(store),
            ],
        )
    )
    return authn, authz


def init_cluster(
    data_dir: str,
    port: int = 0,
    controllers: Optional[List[str]] = None,
    replication: bool = False,
    device: DeviceLike = None,
) -> ClusterHandle:
    """Run every init phase; returns the live control plane. With
    replication=True the store also serves a replication endpoint
    (runtime/replication.py) so standby control planes can tail it —
    handle.replication_address is what `kubeadm standby` dials.

    device: where the Scheduler's snapshot and kernels live (None: the
    CUDA card, raising without one before any phase runs; "cpu" runs on
    the CPU)."""
    from ..apiserver.rest import serve
    from ..client.apiserver import APIServer
    from ..controller.manager import ControllerManager
    from ..runtime.wal import WriteAheadLog
    from ..scheduler import KubeSchedulerConfiguration, Scheduler

    # no card and no explicit device: raise before anything starts
    device = resolve_device(device)
    os.makedirs(data_dir, exist_ok=True)

    # -- phase certs: trust material (bearer tokens stand in for x509) ------
    admin_token = secrets.token_urlsafe(24)
    # bootstrap token in the reference's <id>.<secret> form
    # (cluster-bootstrap/token/util): the id is public (names the JWS
    # signature key on cluster-info), the secret half proves possession
    token_id = secrets.token_hex(3)
    token_secret = secrets.token_urlsafe(16)
    bootstrap_token = f"{token_id}.{token_secret}"
    logger.info("[certs] generated admin + bootstrap tokens")

    # -- phase etcd/control-plane: durable store + REST facade --------------
    store = APIServer(wal=WriteAheadLog(os.path.join(data_dir, "cluster")))
    repl = None
    if replication:
        from ..runtime.replication import ReplicationListener

        repl = ReplicationListener()
        repl.attach(store)
        logger.info(
            "[etcd] replication endpoint on %s:%d", *repl.address
        )
    authn, authz = assemble_security(store, admin_token, bootstrap_token)
    from ..apiserver.audit import AuditLogger

    http_server, port, _ = serve(
        store=store,
        port=port,
        authenticator=authn,
        authorizer=authz,
        audit=AuditLogger(path=os.path.join(data_dir, "audit.jsonl")),
    )
    logger.info("[control-plane] apiserver on :%d (WAL at %s)", port, data_dir)

    # -- phase kubeconfig ----------------------------------------------------
    conf = {
        "server": f"http://127.0.0.1:{port}",
        "token": admin_token,
        "user": "kubernetes-admin",
    }
    with open(os.path.join(data_dir, ADMIN_CONF), "w") as f:
        json.dump(conf, f, indent=2)
    logger.info("[kubeconfig] wrote %s", ADMIN_CONF)

    # -- phase control-plane components -------------------------------------
    sched = Scheduler(store, KubeSchedulerConfiguration(), device=device)
    sched.start()
    cm = ControllerManager(store, controllers=controllers)
    cm.start()
    logger.info("[control-plane] scheduler + controller-manager running")

    # -- phase bootstrap-token: discoverable join secret ---------------------
    from ..api import objects as v1

    store.create(
        "secrets",
        v1.Secret(
            metadata=v1.ObjectMeta(
                name=BOOTSTRAP_TOKEN_SECRET, namespace="kube-system"
            ),
            type="bootstrap.kubernetes.io/token",
            data={
                "token": bootstrap_token.encode(),
                "token-id": token_id.encode(),
                "token-secret": token_secret.encode(),
                "usage-bootstrap-signing": b"true",
            },
        ),
    )
    logger.info("[bootstrap-token] join token stored")

    # -- phase upload-config: kubeadm-config (upgrade's source of truth) -----
    from .. import __version__ as _cluster_version

    store.create(
        "configmaps",
        v1.ConfigMap(
            metadata=v1.ObjectMeta(name="kubeadm-config", namespace="kube-system"),
            data={
                "ClusterConfiguration": json.dumps(
                    {"kubernetesVersion": _cluster_version}
                )
            },
        ),
    )

    # -- phase upload-config/addons: public discovery document ---------------
    # cluster-info in kube-public carries ONLY the server location (no
    # credentials); the bootstrapsigner controller attaches per-token JWS
    # signatures so a joining node can verify it with just its token
    store.create(
        "configmaps",
        v1.ConfigMap(
            metadata=v1.ObjectMeta(name="cluster-info", namespace="kube-public"),
            data={"kubeconfig": json.dumps({"server": f"http://127.0.0.1:{port}"})},
        ),
    )
    logger.info("[upload-config] cluster-info published to kube-public")

    return ClusterHandle(
        store=store,
        http_server=http_server,
        port=port,
        scheduler=sched,
        controller_manager=cm,
        admin_token=admin_token,
        bootstrap_token=bootstrap_token,
        data_dir=data_dir,
        replication=repl,
    )


def standby_cluster(
    primary_addr,
    data_dir: str,
    lease_s: float = 1.0,
    port: int = 0,
    controllers: Optional[List[str]] = None,
    admin_token: Optional[str] = None,
    insecure: bool = False,
    device: DeviceLike = None,
):
    """`kubeadm standby`: a warm control plane behind a replica store.

    Tails the primary's replication stream (full state + live records,
    persisted to its own WAL); when the primary's lease lapses — or
    promote() is called — the replica becomes a LIVE control plane with
    the SAME trust + admission assembly as init (failover must not
    downgrade security; pass the cluster's admin token, or insecure=True
    for the dev port), fences the old primary best-effort (higher-term
    hello — a merely-stalled primary steps down read-only instead of
    splitting the brain), and the scheduler re-lists from the replicated
    state. Returns a StandbyHandle with .wait_promoted()/.promote().

    device: where the promoted Scheduler runs (None: the CUDA card,
    raising here without one, before the follower dials; "cpu" runs on
    the CPU)."""
    from ..runtime.replication import Follower
    from ..runtime.wal import WriteAheadLog

    device = resolve_device(device)
    if admin_token is None and not insecure:
        raise ValueError(
            "standby_cluster needs the cluster admin token (or insecure=True):"
            " a promoted control plane must keep authenticating"
        )
    os.makedirs(data_dir, exist_ok=True)

    class StandbyHandle:
        def __init__(self):
            self.follower = None
            self.cluster: Optional[ClusterHandle] = None
            self.promote_error: Optional[BaseException] = None
            self._promoted = threading.Event()

        def wait_promoted(self, timeout: float = 30.0) -> bool:
            return self._promoted.wait(timeout)

        def promote(self) -> ClusterHandle:
            self.follower.promote()
            if not self.wait_promoted():
                raise RuntimeError("standby promotion timed out")
            if self.cluster is None:
                raise RuntimeError(
                    f"standby promotion failed: {self.promote_error}"
                )
            return self.cluster

        def stop(self):
            self.follower.stop()
            if self.cluster is not None:
                self.cluster.stop()

    handle = StandbyHandle()

    def on_promote(server):
        try:
            from ..apiserver.audit import AuditLogger
            from ..apiserver.rest import serve
            from ..controller.manager import ControllerManager
            from ..scheduler import KubeSchedulerConfiguration, Scheduler

            if insecure:
                authn = authz = None
            else:
                authn, authz = assemble_security(server, admin_token)
            http_server, bound_port, _ = serve(
                store=server,
                port=port,
                authenticator=authn,
                authorizer=authz,
                audit=AuditLogger(path=os.path.join(data_dir, "audit.jsonl")),
            )
            sched = Scheduler(server, KubeSchedulerConfiguration(), device=device)
            sched.start()
            cmgr = ControllerManager(server, controllers=controllers)
            cmgr.start()
            handle.cluster = ClusterHandle(
                store=server,
                http_server=http_server,
                port=bound_port,
                scheduler=sched,
                controller_manager=cmgr,
                admin_token=admin_token or "",
                bootstrap_token="",
                data_dir=data_dir,
            )
            logger.warning(
                "[standby] promoted: control plane serving on :%d", bound_port
            )
        except BaseException as e:  # surfaced by StandbyHandle.promote
            handle.promote_error = e
            raise
        finally:
            handle._promoted.set()

    handle.follower = Follower(
        primary_addr,
        lease_s=lease_s,
        wal=WriteAheadLog(os.path.join(data_dir, "cluster")),
        on_promote=on_promote,
    ).start()
    return handle


def discover_cluster_info(
    server_url: str, token: str, timeout: float = 10.0
) -> dict:
    """Bootstrap token discovery (cmd/kubeadm/app/discovery/token): fetch
    the kube-public cluster-info document and verify its detached JWS
    signature with the `<id>.<secret>` token before trusting anything in
    it. Raises PermissionError on a missing or wrong signature — an
    unsigned endpoint could be an impostor control plane."""
    import time as _time

    from ..apiserver.client import AuthRESTClient
    from ..controller.bootstrap import JWS_PREFIX, compute_detached_signature

    token_id, _, token_secret = token.partition(".")
    client = AuthRESTClient(server_url, token=token)
    deadline = _time.monotonic() + timeout
    last = "cluster-info not found"
    while _time.monotonic() < deadline:
        try:
            cm = client.get("configmaps", "kube-public", "cluster-info")
            content = cm.data.get("kubeconfig", "")
            sig = cm.data.get(JWS_PREFIX + token_id, "")
            if sig and content:
                want = compute_detached_signature(content, token_id, token_secret)
                if sig == want:
                    return json.loads(content)
                raise PermissionError(
                    "cluster-info signature mismatch for token id "
                    f"{token_id!r}: refusing to join"
                )
            last = f"no signature yet for token id {token_id!r}"
        except PermissionError:
            raise
        except Exception as e:  # not served yet / signer still reconciling
            last = str(e)
        _time.sleep(0.2)
    raise PermissionError(f"cluster-info discovery failed: {last}")


def _request_node_credential(
    client, node_name: str, timeout_s: float = 10.0
) -> str:
    """File a kubelet CSR and wait for the signed credential ('' on
    timeout). Reference flow: kubelet TLS bootstrap — CSR with
    CN=system:node:<name>, O=system:nodes, auto-approved (sarapprove) and
    signed (certificates signer)."""
    from ..api import objects as v1
    from ..client.apiserver import AlreadyExists

    csr_name = f"node-csr-{node_name}"
    csr = v1.CertificateSigningRequest(
        metadata=v1.ObjectMeta(name=csr_name, namespace=""),
        spec=v1.CertificateSigningRequestSpec(
            request=node_name,
            username=f"system:node:{node_name}",
            groups=["system:nodes"],
            usages=["client auth"],
            signer_name="kubernetes.io/kube-apiserver-client-kubelet",
        ),
    )
    try:
        client.create("certificatesigningrequests", csr)
    except AlreadyExists:
        pass
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            cur = client.get("certificatesigningrequests", "", csr_name)
        except Exception:
            cur = None
        cert = cur.status.certificate if cur is not None else ""
        if cert:
            return cert
        time.sleep(0.1)
    return ""


def join_node(
    server_url: str,
    token: str,
    node_name: str,
    cpu: str = "8",
    memory: str = "32Gi",
    handle: Optional[ClusterHandle] = None,
):
    """`kubeadm join`: register the node over the bootstrap token and run a
    node agent against the API (remote client, same kubelet code path).
    When `handle` is given (in-process clusters), the pool is owned by it
    and stops with ClusterHandle.stop()."""
    from ..apiserver.client import AuthRESTClient
    from ..client.apiserver import AlreadyExists
    from ..kubelet.kubelet import NodeAgentPool
    from ..kubemark.hollow_node import make_hollow_node

    if "." in token:
        # <id>.<secret> form: verify the control plane's identity via the
        # signed discovery document before registering with it
        info = discover_cluster_info(server_url, token)
        server_url = info.get("server", server_url)
    client = AuthRESTClient(server_url, token=token)
    node = make_hollow_node(node_name, cpu=cpu, memory=memory)
    try:
        client.create("nodes", node)
    except AlreadyExists:
        pass  # re-join of a registered node
    # TLS-bootstrap analogue (kubeadm's kubelet-start phase): trade the
    # shared bootstrap token for a per-node identity. The CSR auto-approve
    # + signing controllers issue the credential; the authenticator's
    # signed-CSR index then maps it to system:node:<name> in the
    # system:nodes group, where the node authorizer's decision table
    # applies. If the control plane runs without those controllers, stay
    # on the bootstrap token (degraded but functional).
    try:
        cred = _request_node_credential(client, node_name)
        if cred:
            client._headers["Authorization"] = f"Bearer {cred}"
            logger.info("[join] node %s holds its node identity", node_name)
    except Exception:
        logger.exception("node credential bootstrap failed; keeping token")
    pool = NodeAgentPool(client)
    pool.add_node(node_name, register=False)
    pool.start()
    if handle is not None:
        handle._joined.append(pool)
    logger.info("[join] node %s registered and heartbeating", node_name)
    return pool


def upgrade_plan(server) -> dict:
    """`kubeadm upgrade plan` (cmd/kubeadm/app/cmd/upgrade/plan.go):
    compare the cluster's recorded version (kubeadm-config) with the
    version this binary ships."""
    from .. import __version__ as target

    try:
        cm = server.get("configmaps", "kube-system", "kubeadm-config")
        current = json.loads(cm.data.get("ClusterConfiguration", "{}")).get(
            "kubernetesVersion", "unknown"
        )
    except Exception:
        current = "unknown"
    return {
        "current": current,
        "target": target,
        "upgrade_available": current != target,
    }


def upgrade_apply(server, target: Optional[str] = None) -> dict:
    """`kubeadm upgrade apply` (…/upgrade/apply.go): refuse downgrades and
    migrate the stored cluster configuration to the new version — the
    config-migration half of the reference's apply (component manifests
    don't exist in an in-process control plane). Idempotent."""
    from .. import __version__ as binary_version

    target = target or binary_version
    plan = upgrade_plan(server)
    current = plan["current"]

    def _key(vs: str):
        try:
            return tuple(int(x) for x in vs.lstrip("v").split("-")[0].split("."))
        except ValueError:
            return ()

    if _key(target) < _key(current):
        raise ValueError(
            f"downgrade {current} -> {target} is not supported "
            "(upgrade/apply.go version skew policy)"
        )

    def mutate(cm):
        cfg = json.loads(cm.data.get("ClusterConfiguration", "{}"))
        if cfg.get("kubernetesVersion") == target:
            return None
        cfg["kubernetesVersion"] = target
        cm.data["ClusterConfiguration"] = json.dumps(cfg)
        return cm

    from ..client.apiserver import NotFound

    try:
        server.guaranteed_update(
            "configmaps", "kube-system", "kubeadm-config", mutate
        )
    except NotFound:
        from ..api import objects as v1

        server.create(
            "configmaps",
            v1.ConfigMap(
                metadata=v1.ObjectMeta(
                    name="kubeadm-config", namespace="kube-system"
                ),
                data={
                    "ClusterConfiguration": json.dumps(
                        {"kubernetesVersion": target}
                    )
                },
            ),
        )
    logger.info("[upgrade] cluster %s -> %s", current, target)
    return {"from": current, "to": target}


_PLATFORM_HELP = (
    "'cpu' runs the control plane's scheduler on the CPU; any other "
    "value, or none, runs it on the CUDA card"
)


def _device_of(platform: str) -> DeviceLike:
    return "cpu" if platform == "cpu" else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kubeadm-tpu")
    sub = parser.add_subparsers(dest="verb", required=True)
    p_init = sub.add_parser("init")
    p_init.add_argument("--data-dir", default="./kubeadm-data")
    p_init.add_argument("--port", type=int, default=18080)
    p_init.add_argument("--with-replication", action="store_true")
    p_init.add_argument("--platform", default="", help=_PLATFORM_HELP)
    p_join = sub.add_parser("join")
    p_join.add_argument("server")
    p_join.add_argument("--token", required=True)
    p_join.add_argument("--node-name", default="node-joined")
    p_standby = sub.add_parser("standby")
    p_standby.add_argument("primary")  # host:port of the replication endpoint
    p_standby.add_argument("--data-dir", default="./kubeadm-standby")
    p_standby.add_argument("--lease-seconds", type=float, default=2.0)
    p_standby.add_argument(
        "--token",
        default="",
        help="cluster admin token the promoted plane authenticates with "
        "(omitting it serves the promoted plane on the insecure port)",
    )
    p_standby.add_argument("--platform", default="", help=_PLATFORM_HELP)
    p_up = sub.add_parser("upgrade")
    p_up.add_argument("phase", choices=["plan", "apply"])
    p_up.add_argument("server")
    p_up.add_argument("--token", required=True)
    p_up.add_argument("--version", default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.verb == "init":
        handle = init_cluster(
            args.data_dir,
            args.port,
            replication=args.with_replication,
            device=_device_of(args.platform),
        )
        print(
            "cluster initialized.\n"
            f"  admin conf: {os.path.join(args.data_dir, ADMIN_CONF)}\n"
            "join nodes with:\n"
            f"  kubeadm-tpu join {handle.server_url} --token {handle.bootstrap_token}"
        )
        if handle.replication_address:
            host, rport = handle.replication_address
            print(f"standby control planes: kubeadm-tpu standby {host}:{rport}")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            handle.stop()
        return 0
    if args.verb == "join":
        pool = join_node(args.server, args.token, args.node_name)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pool.stop()
        return 0
    if args.verb == "standby":
        host, _, port_s = args.primary.rpartition(":")
        if not host or not port_s.isdigit():
            parser.error(f"standby target must be HOST:PORT, got {args.primary!r}")
        handle = standby_cluster(
            (host, int(port_s)),
            args.data_dir,
            lease_s=args.lease_seconds,
            admin_token=args.token or None,
            insecure=not args.token,
            device=_device_of(args.platform),
        )
        print(f"standby tailing {args.primary}; promotes on lease expiry")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            handle.stop()
        return 0
    if args.verb == "upgrade":
        from ..apiserver.client import AuthRESTClient

        client = AuthRESTClient(args.server, token=args.token)
        if args.phase == "plan":
            print(json.dumps(upgrade_plan(client), indent=2))
        else:
            print(json.dumps(upgrade_apply(client, args.version), indent=2))
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
