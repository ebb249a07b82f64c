"""cloud-controller-manager: service load balancers + routes against a
cloud-provider interface.

Reference: cmd/cloud-controller-manager + pkg/controller/cloud +
staging/src/k8s.io/cloud-provider — the cloud loops talk to a provider
interface (LoadBalancer / Routes / Instances); kubernetes ships the
interface and providers implement it. Here ``FakeCloudProvider`` is the
in-tree test provider equivalent (cloud-provider/fake): an in-memory
cloud whose state the tests can inspect.

Loops:
  * ServiceLBController — Services of type LoadBalancer get a provisioned
    cloud LB (ingress IP in status.loadBalancer + spec.external_ips, LB
    backend hosts kept in step with ready nodes); deleting the service or
    flipping its type tears the LB down.
  * RouteController — one cloud route per node pod CIDR
    (pkg/controller/route): created when nodeipam assigns the CIDR,
    removed with the node.
  * CloudNodeController — initializes new nodes from cloud instance
    metadata: clears the cloudprovider uninitialized taint, sets
    providerID, instance-type/zone labels and node addresses
    (pkg/controller/cloud/node_controller.go).
  * CloudNodeLifecycleController — periodically verifies each node's
    instance still exists in the cloud; gone -> the Node object is
    deleted, shutdown -> the shutdown taint
    (pkg/controller/cloud/node_lifecycle_controller.go).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from ..api import objects as v1
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.cloud")

# the cloud taints (cloud-provider api/well_known_taints.go): new nodes
# register with the uninitialized taint until the cloud controller
# initializes them; shutdown instances get the shutdown taint
TAINT_UNINITIALIZED = "node.cloudprovider.kubernetes.io/uninitialized"
TAINT_SHUTDOWN = "node.cloudprovider.kubernetes.io/shutdown"


class CloudInstance:
    """One cloud VM's metadata (cloud-provider Instances record)."""

    __slots__ = (
        "provider_id", "instance_type", "zone", "addresses", "exists",
        "shutdown",
    )

    def __init__(
        self,
        provider_id: str = "",
        instance_type: str = "tpu.standard-4",
        zone: str = "zone-a",
        addresses: Optional[Tuple[Tuple[str, str], ...]] = None,  # (type, addr)
        exists: bool = True,
        shutdown: bool = False,
    ):
        self.provider_id = provider_id
        self.instance_type = instance_type
        self.zone = zone
        self.addresses = addresses or ()
        self.exists = exists
        self.shutdown = shutdown


class FakeCloudProvider:
    """In-memory cloud (cloud-provider/fake equivalent): LoadBalancer,
    Routes and Instances interfaces."""

    def __init__(self, lb_prefix: str = "203.0.113"):
        self._lock = threading.Lock()
        self.load_balancers: Dict[str, str] = {}  # service key -> external IP
        self.lb_hosts: Dict[str, Tuple[str, ...]] = {}  # svc key -> node names
        self.routes: Dict[str, str] = {}  # node name -> pod CIDR
        self.instances: Dict[str, CloudInstance] = {}  # node name -> VM
        self._next_lb = 1
        self.lb_prefix = lb_prefix

    # LoadBalancer interface
    def ensure_load_balancer(self, service_key: str, hosts=()) -> str:
        with self._lock:
            ip = self.load_balancers.get(service_key)
            if ip is None:
                ip = f"{self.lb_prefix}.{self._next_lb}"
                self._next_lb += 1
                self.load_balancers[service_key] = ip
            self.lb_hosts[service_key] = tuple(hosts)
            return ip

    def update_load_balancer_hosts(self, service_key: str, hosts) -> None:
        with self._lock:
            if service_key in self.load_balancers:
                self.lb_hosts[service_key] = tuple(hosts)

    def delete_load_balancer(self, service_key: str) -> None:
        with self._lock:
            self.load_balancers.pop(service_key, None)
            self.lb_hosts.pop(service_key, None)

    # Routes interface
    def create_route(self, node: str, cidr: str) -> None:
        with self._lock:
            self.routes[node] = cidr

    def delete_route(self, node: str) -> None:
        with self._lock:
            self.routes.pop(node, None)

    def list_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.routes)

    # Instances interface
    def add_instance(self, node: str, inst: Optional[CloudInstance] = None) -> CloudInstance:
        with self._lock:
            i = inst or CloudInstance(provider_id=f"fake://{node}")
            if not i.provider_id:
                i.provider_id = f"fake://{node}"
            self.instances[node] = i
            return i

    def instance(self, node: str) -> Optional[CloudInstance]:
        with self._lock:
            return self.instances.get(node)

    def instance_exists(self, node: str) -> bool:
        with self._lock:
            i = self.instances.get(node)
            return i is not None and i.exists

    def instance_shutdown(self, node: str) -> bool:
        with self._lock:
            i = self.instances.get(node)
            return i is not None and i.shutdown


class ServiceLBController(WorkqueueController):
    name = "service-lb"
    primary_kind = "services"
    # node events refresh every LB's backend host set (the reference's
    # service controller watches nodes for exactly this)
    secondary_kinds = ("nodes",)

    def __init__(self, server, cloud: Optional[FakeCloudProvider] = None, workers: int = 1):
        super().__init__(server, workers=workers)
        self.cloud = cloud or FakeCloudProvider()

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        if resource == "nodes":
            # host-set refresh is world-scoped, not per-service: do it
            # inline (cheap: one node list per burst of node events) and
            # requeue nothing
            try:
                self.sync_hosts()
            except Exception:
                logger.exception("LB host sync failed")
            return None
        return None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            svc = self.server.get("services", ns, name)
        except NotFound:
            self.cloud.delete_load_balancer(key)
            return
        if svc.spec.type != "LoadBalancer":
            if key in self.cloud.load_balancers:
                self.cloud.delete_load_balancer(key)
                self._set_external_ips(ns, name, [])
            return
        ip = self.cloud.ensure_load_balancer(key, hosts=self._ready_nodes())
        if ip not in svc.spec.external_ips:
            self._set_external_ips(ns, name, [ip])

    def _ready_nodes(self):
        """LB backend hosts = schedulable Ready nodes (the reference's
        host-set the service controller keeps in step on node changes)."""
        try:
            nodes, _ = self.server.list("nodes")
        except Exception:
            return ()
        out = []
        for n in nodes:
            if n.spec.unschedulable:
                continue
            ready = any(
                c.type == v1.NODE_READY and c.status == "True"
                for c in n.status.conditions
            )
            if ready:
                out.append(n.metadata.name)
        return tuple(sorted(out))

    def sync_hosts(self) -> None:
        """Node-change hook: refresh every provisioned LB's host set
        (UpdateLoadBalancerHosts on node add/remove/readiness flip)."""
        hosts = self._ready_nodes()
        for key in list(self.cloud.load_balancers):
            self.cloud.update_load_balancer_hosts(key, hosts)

    def _set_external_ips(self, ns: str, name: str, ips) -> None:
        def mutate(s):
            if (
                s.spec.external_ips == list(ips)
                and s.status.load_balancer.ingress == list(ips)
            ):
                return None
            s.spec.external_ips = list(ips)
            s.status.load_balancer.ingress = list(ips)
            return s

        try:
            self.server.guaranteed_update("services", ns, name, mutate)
        except NotFound:
            pass


class RouteController(WorkqueueController):
    name = "route"
    primary_kind = "nodes"
    secondary_kinds = ()

    def __init__(self, server, cloud: Optional[FakeCloudProvider] = None, workers: int = 1):
        super().__init__(server, workers=workers)
        self.cloud = cloud or FakeCloudProvider()

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            node = self.server.get("nodes", ns, name)
        except NotFound:
            self.cloud.delete_route(name)
            return
        if node.spec.pod_cidr:
            if self.cloud.list_routes().get(name) != node.spec.pod_cidr:
                self.cloud.create_route(name, node.spec.pod_cidr)


class CloudNodeController(WorkqueueController):
    """Node initialization from cloud metadata
    (pkg/controller/cloud/node_controller.go): a kubelet registering with
    --cloud-provider=external adds the uninitialized taint; this loop
    looks the instance up, stamps providerID / instance-type and zone
    labels / addresses, and removes the taint so the node becomes
    schedulable."""

    name = "cloud-node"
    primary_kind = "nodes"
    secondary_kinds = ()

    LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
    LABEL_ZONE = "topology.kubernetes.io/zone"

    def __init__(self, server, cloud: Optional[FakeCloudProvider] = None, workers: int = 1):
        super().__init__(server, workers=workers)
        self.cloud = cloud or FakeCloudProvider()

    def sync(self, key: str) -> None:
        _ns, _, name = key.rpartition("/")
        try:
            node = self.server.get("nodes", "", name)
        except NotFound:
            return
        if not any(t.key == TAINT_UNINITIALIZED for t in node.spec.taints):
            return
        inst = self.cloud.instance(name)
        if inst is None or not inst.exists:
            return  # not in the cloud yet: retried on the next node event

        def mutate(n):
            n.spec.taints = [
                t for t in n.spec.taints if t.key != TAINT_UNINITIALIZED
            ]
            n.spec.provider_id = inst.provider_id
            n.metadata.labels.setdefault(
                self.LABEL_INSTANCE_TYPE, inst.instance_type
            )
            n.metadata.labels.setdefault(self.LABEL_ZONE, inst.zone)
            if inst.addresses:
                # NodeStatus.addresses rows are (type, address) pairs
                n.status.addresses = [tuple(a) for a in inst.addresses]
            return n

        try:
            self.server.guaranteed_update("nodes", "", name, mutate)
        except NotFound:
            pass


class CloudNodeLifecycleController:
    """Instance-existence sweep
    (pkg/controller/cloud/node_lifecycle_controller.go): nodes whose
    cloud instance is GONE are deleted from the API (their pods then ride
    the normal nodelifecycle eviction); SHUTDOWN instances get the
    shutdown NoSchedule taint until they come back. Runs as a periodic
    monitor, not a workqueue — existence is a cloud-side fact with no
    API event to react to."""

    def __init__(
        self,
        server,
        cloud: Optional[FakeCloudProvider] = None,
        period_s: float = 5.0,
    ):
        self.server = server
        self.cloud = cloud or FakeCloudProvider()
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="cloud-node-lifecycle"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sweep()
            except Exception:
                logger.exception("cloud node lifecycle sweep failed")

    def sweep(self) -> None:  # graftlint: degraded-ok(the run loop catches everything and retries the sweep next period)
        try:
            nodes, _ = self.server.list("nodes")
        except Exception:
            return
        for node in nodes:
            name = node.metadata.name
            if self.cloud.instance(name) is None:
                continue  # never cloud-managed (e.g. not registered)
            if not self.cloud.instance_exists(name):
                logger.info("node %s gone from the cloud; deleting", name)
                try:
                    self.server.delete("nodes", "", name)
                except NotFound:
                    pass
                continue
            shutdown = self.cloud.instance_shutdown(name)
            has_taint = any(
                t.key == TAINT_SHUTDOWN for t in node.spec.taints
            )
            if shutdown == has_taint:
                continue

            def mutate(n, want=shutdown):
                if want:
                    n.spec.taints = list(n.spec.taints) + [
                        v1.Taint(key=TAINT_SHUTDOWN, effect=v1.TAINT_NO_SCHEDULE)
                    ]
                else:
                    n.spec.taints = [
                        t for t in n.spec.taints if t.key != TAINT_SHUTDOWN
                    ]
                return n

            try:
                self.server.guaranteed_update("nodes", "", name, mutate)
            except NotFound:
                pass
