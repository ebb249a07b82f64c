"""Node agent: pod sync loop + status + heartbeats.

Reference: pkg/kubelet/kubelet.go — Run(:1401) starts the sync machinery,
syncLoop(:1820)/syncLoopIteration(:1894) select over config updates, PLEG
events, and housekeeping; syncPod(:1482) drives the runtime. This build
keeps the same event structure but multiplexes many nodes onto shared
threads (NodeAgentPool) so a 5k-node hollow cluster is cheap — one watch
stream feeds per-node Kubelet objects that share one code path whether the
runtime is fake (kubemark) or real.

Heartbeats follow the nodelease KEP: renew a Lease every interval and keep
the NodeStatus Ready condition fresh (pkg/kubelet/nodelease; nodelifecycle
watches both).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import objects as v1
from ..client.apiserver import Conflict, NotFound, NotPrimary
from ..client.leaderelection import Lease
from ..runtime.consensus import DegradedWrites
from ..runtime.watch import BOOKMARK
from ..utils.metrics import metrics
from .runtime import FakeRuntime, PodRuntime

logger = logging.getLogger("kubernetes_tpu.kubelet")

NODE_LEASE_NS = "kube-node-lease"

# status/condition writes dropped while the store is degraded: counted
# skips, never raises — the next sync/housekeeping cycle retries, and
# failing the shared pool threads over a read-only store would turn one
# outage into a fleet-wide kubelet stall (PR-3 ride-through discipline,
# enforced tree-wide by graftlint's degraded-write pass)
COUNTER_DEGRADED_SKIPS = "kubelet_degraded_write_skips_total"  # {write}


def skip_degraded_write(write: str) -> None:
    metrics.inc(COUNTER_DEGRADED_SKIPS, {"write": write})


def make_node_object(
    name: str,
    cpu: str = "4",
    memory: str = "32Gi",
    pods: int = 110,
    labels: Optional[dict] = None,
) -> v1.Node:
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace="", labels=labels or {}),
        spec=v1.NodeSpec(),
        status=v1.NodeStatus(
            capacity={"cpu": cpu, "memory": memory, "pods": pods},
            allocatable={"cpu": cpu, "memory": memory, "pods": pods},
            conditions=[v1.NodeCondition(type=v1.NODE_READY, status="True")],
        ),
    )


class _ProbeWorker:
    """One (pod, kind) prober (pkg/kubelet/prober/worker.go): tracks
    consecutive results against the probe's thresholds."""

    __slots__ = ("probe", "started", "last_run", "succ", "fail", "result")

    def __init__(self, probe: v1.Probe, now: float):
        self.probe = probe
        self.started = now
        self.last_run = float("-inf")
        self.succ = 0
        self.fail = 0
        # readiness starts False (pod not Ready until the probe passes);
        # liveness starts True (a container is assumed live until proven
        # otherwise) — prober/worker.go initialValue
        self.result: bool = False

    def due(self, now: float) -> bool:
        if now - self.started < self.probe.initial_delay_seconds:
            return False
        return now - self.last_run >= self.probe.period_seconds

    def observe(self, ok: bool, now: float) -> bool:
        """Record one probe result; returns the (possibly flipped)
        effective result."""
        self.last_run = now
        if ok:
            self.succ += 1
            self.fail = 0
            if self.succ >= self.probe.success_threshold:
                self.result = True
        else:
            self.fail += 1
            self.succ = 0
            if self.fail >= self.probe.failure_threshold:
                self.result = False
        return self.result


class Kubelet:
    """One node's agent. Thread-free: the pool (or a test) drives it via
    handle_pod_event / housekeeping / heartbeat."""

    def __init__(
        self,
        server,
        node_name: str,
        runtime: PodRuntime,
        host_ip: Optional[str] = None,
        device_manager=None,
    ):
        self.server = server
        self.node_name = node_name
        self.runtime = runtime
        self.host_ip = host_ip  # the node's address (same for all its pods)
        # optional device-plugin manager (devicemanager.DeviceManager):
        # allocates plugin devices at pod admission, frees on termination,
        # and surfaces extended-resource capacity into NodeStatus
        self.device_manager = device_manager
        self._device_generation = -1
        # optional volume manager (volumemanager.VolumeManager): PVC pods
        # wait for attach+mount before the sandbox starts
        self.volume_manager = None
        # optional node-pressure eviction manager (eviction.EvictionManager)
        self.eviction_manager = None
        # optional container manager (cm.ContainerManager): reserved-
        # resource accounting — allocatable = capacity - reservations is
        # posted to NodeStatus so the scheduler packs against it
        self.container_manager = None
        self._allocatable_synced = False
        self._wait_volumes: Dict[str, v1.Pod] = {}  # parked on mounts
        self._known: Dict[str, str] = {}  # pod key -> last posted phase
        self._specs: Dict[str, v1.Pod] = {}  # pod key -> last seen spec
        # prober bookkeeping (pkg/kubelet/prober): (key, kind) -> worker
        self._probes: Dict[tuple, _ProbeWorker] = {}

    # -- pod lifecycle (syncPod, kubelet.go:1482) ----------------------------

    def handle_pod_event(self, ev_type: str, pod: v1.Pod) -> None:
        if pod.spec.node_name != self.node_name:
            return
        key = pod.metadata.key
        if ev_type == "DELETED":
            self.runtime.kill_pod(key)
            self._known.pop(key, None)
            self._forget_probes(key)
            self._wait_volumes.pop(key, None)
            if self.device_manager is not None:
                self.device_manager.free_pod(key)
            if self.volume_manager is not None:
                self.volume_manager.forget_pod(key)
            return
        if pod.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED):
            # terminal: runtime resources are reclaimed, status stands
            self.runtime.kill_pod(key)
            self._known[key] = pod.status.phase
            self._forget_probes(key)
            if self.device_manager is not None:
                self.device_manager.free_pod(key)
            return
        self._specs[key] = pod
        if key not in self._known:
            if self.device_manager is not None:
                # device admission BEFORE the sandbox starts (the manager's
                # Allocate ordering in kubelet admission, manager.go)
                try:
                    self.device_manager.allocate_pod(pod)
                except Exception as e:
                    self._post_admission_failure(pod, str(e))
                    self._known[key] = v1.POD_FAILED
                    return
            if self.volume_manager is not None:
                # WaitForAttachAndMount: a PVC pod parks until its volumes
                # are set up; housekeeping reconciles + retries
                self.volume_manager.note_pod(pod)
                if not self.volume_manager.mounts_ready(pod):
                    self.volume_manager.reconcile()
                if not self.volume_manager.mounts_ready(pod):
                    self._wait_volumes[key] = pod
                    return
                self._wait_volumes.pop(key, None)
            self._ensure_images(pod)
            ip = self.runtime.run_pod(pod)
            self._known[key] = v1.POD_RUNNING
            # phase and the initial Ready verdict land in ONE status write:
            # posting them separately opens a window where Running exists
            # with no Ready condition and pod_is_ready() defaults to True —
            # endpoints would briefly publish a warming-up pod
            self._post_status(
                pod,
                v1.POD_RUNNING,
                ip,
                ready=self._probe_of(pod, "readiness") is None,
            )
            self._start_probes(pod, post_ready=False)

    def _ensure_images(self, pod: v1.Pod) -> None:
        """Image-pull step before the sandbox starts (the reference's
        imageManager.EnsureImageExists per container): honored when the
        runtime exposes an ImageService (pull_image/image_status —
        RemoteRuntime does); policy Always re-pulls, IfNotPresent (the
        default) pulls only when the image is absent, Never skips."""
        pull = getattr(self.runtime, "pull_image", None)
        if pull is None:
            return
        status = getattr(self.runtime, "image_status", None)
        for c in pod.spec.containers:
            if not c.image:
                continue
            policy = c.image_pull_policy or "IfNotPresent"
            if policy == "Never":
                continue
            try:
                if (
                    policy == "IfNotPresent"
                    and status is not None
                    and status(c.image) is not None
                ):
                    continue
                pull(c.image)
            except Exception:
                logger.exception("image pull %s failed", c.image)

    def housekeeping(self) -> None:
        """PLEG relist → post phase transitions (pleg/generic.go 1s relist)."""
        for key, phase in self.runtime.relist().items():
            if self._known.get(key) == phase:
                continue
            ns, _, name = key.partition("/")
            try:
                pod = self.server.get("pods", ns, name)
            except NotFound:
                self.runtime.kill_pod(key)
                self._known.pop(key, None)
                self._forget_probes(key)
                continue
            self._known[key] = phase
            if phase in (v1.POD_SUCCEEDED, v1.POD_FAILED):
                self.runtime.kill_pod(key)
                self._forget_probes(key)
                if self.device_manager is not None:
                    self.device_manager.free_pod(key)
                self._post_status(pod, phase, None)
        self.sync_device_capacity()
        self.sync_node_allocatable()
        if self.eviction_manager is not None:
            try:
                self.eviction_manager.synchronize()
            except Exception:
                logger.exception("eviction manager pass failed")
        if self.volume_manager is not None:
            self.volume_manager.reconcile()
            for key, pod in list(self._wait_volumes.items()):
                if self.volume_manager.mounts_ready(pod):
                    del self._wait_volumes[key]
                    self.handle_pod_event("ADDED", pod)
        self.publish_pod_stats()
        self.run_probes()

    # cAdvisor-analogue sampling state: pod key -> (cpu_seconds, mono_ts)
    _stat_samples: Optional[Dict[str, tuple]] = None
    _stats_published_at: float = float("-inf")
    stats_publish_interval_s: float = 10.0  # metrics-server resolution

    def publish_pod_stats(self) -> None:
        """Real usage -> the metrics pipeline: when the runtime measures
        actual processes (ProcessRuntime.pod_stats reading /proc), derive
        a CPU rate between housekeeping passes and publish it on the pod
        as the metrics.kubernetes.io annotations the metrics.k8s.io
        endpoints and HPA consume (the cAdvisor → summary API flow).
        Throttled to the metrics-server's ~10 s resolution: at the 1 s
        PLEG cadence an unthrottled pass would add a write + a MODIFIED
        fan-out to every pod informer per active pod per second."""
        stats_fn = getattr(self.runtime, "pod_stats", None)
        if stats_fn is None:
            return
        now = time.monotonic()
        if now - self._stats_published_at < self.stats_publish_interval_s:
            return
        self._stats_published_at = now
        if self._stat_samples is None:
            self._stat_samples = {}
        for key in list(self._known):
            cpu_s, rss = stats_fn(key)
            prev = self._stat_samples.get(key)
            self._stat_samples[key] = (cpu_s, now)
            if prev is None:
                continue
            prev_cpu, prev_ts = prev
            dt = now - prev_ts
            if dt <= 0:
                continue
            millicores = max(0, int((cpu_s - prev_cpu) / dt * 1000))
            ns, _, name = key.partition("/")

            def mutate(p, mc=millicores, mem=rss):
                ann = p.metadata.annotations
                new_cpu, new_mem = f"{mc}m", str(mem)
                if (
                    ann.get("metrics.kubernetes.io/cpu-usage") == new_cpu
                    and ann.get("metrics.kubernetes.io/memory-usage") == new_mem
                ):
                    return None  # no-op write suppression
                ann["metrics.kubernetes.io/cpu-usage"] = new_cpu
                ann["metrics.kubernetes.io/memory-usage"] = new_mem
                return p

            try:
                self.server.guaranteed_update("pods", ns, name, mutate)
            except NotFound:
                self._stat_samples.pop(key, None)
            except DegradedWrites:
                skip_degraded_write("pod_stats")
        for key in list(self._stat_samples):
            if key not in self._known:
                del self._stat_samples[key]

    # -- probes (pkg/kubelet/prober) -----------------------------------------

    @staticmethod
    def _probe_of(pod: v1.Pod, kind: str):
        """Effective pod-level probe: the runtime health channel is
        pod-scoped (one sandbox verdict per kind), so multiple containers'
        probes collapse to the STRICTEST combination — shortest period,
        longest warmup, fewest failures tolerated, most successes
        required. (The reference ANDs per-container results; with a
        pod-scoped runtime the strictest-config collapse is the closest
        sound equivalent.)"""
        attr = "readiness_probe" if kind == "readiness" else "liveness_probe"
        probes = [getattr(c, attr) for c in pod.spec.containers if getattr(c, attr)]
        if not probes:
            return None
        if len(probes) == 1:
            return probes[0]
        return v1.Probe(
            period_seconds=min(p.period_seconds for p in probes),
            initial_delay_seconds=max(p.initial_delay_seconds for p in probes),
            failure_threshold=min(p.failure_threshold for p in probes),
            success_threshold=max(p.success_threshold for p in probes),
        )

    def _start_probes(
        self, pod: v1.Pod, now: Optional[float] = None, post_ready: bool = True
    ) -> None:
        now = now if now is not None else time.monotonic()
        key = pod.metadata.key
        for kind in ("readiness", "liveness"):
            p = self._probe_of(pod, kind)
            if p is not None:
                w = _ProbeWorker(p, now)
                if kind == "liveness":
                    w.result = True
                self._probes[(key, kind)] = w
        if post_ready:
            # restart path: the restarted container warms up again, so a
            # probe-bearing pod drops out of Ready; probe-less pods are
            # Ready whenever Running (status_manager)
            self._post_ready(pod, (key, "readiness") not in self._probes)

    def _forget_probes(self, key: str) -> None:
        self._specs.pop(key, None)
        self._probes.pop((key, "readiness"), None)
        self._probes.pop((key, "liveness"), None)

    def run_probes(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        for (key, kind), w in list(self._probes.items()):
            if self._known.get(key) != v1.POD_RUNNING or not w.due(now):
                continue
            pod = self._specs.get(key)
            if pod is None:
                continue
            before = w.result
            after = w.observe(self.runtime.probe(key, kind), now)
            if kind == "readiness":
                if after != before:
                    self._post_ready(pod, after)
            elif before and not after:
                # liveness remediation: restart the containers in place
                # (restart policy Always semantics), count it, and reset
                # both probes — the restarted container warms up again
                self.runtime.restart_pod(key)
                self._bump_restart_count(pod)
                self._start_probes(pod, now)

    def _post_ready(self, pod: v1.Pod, ready: bool) -> None:
        status = "True" if ready else "False"

        def mutate(p):
            if p.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED):
                return None
            for c in p.status.conditions:
                if c.type == v1.COND_POD_READY:
                    if c.status == status:
                        return None
                    c.status = status
                    c.last_transition_time = time.time()
                    return p
            p.status.conditions.append(
                v1.PodCondition(type=v1.COND_POD_READY, status=status)
            )
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("pod_ready")

    def _bump_restart_count(self, pod: v1.Pod) -> None:
        names = [c.name or f"c{i}" for i, c in enumerate(pod.spec.containers)]

        def mutate(p):
            if not p.status.container_statuses:
                p.status.container_statuses = [
                    v1.ContainerStatus(name=n, ready=False) for n in names
                ]
            for cs in p.status.container_statuses:
                cs.restart_count += 1
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("restart_count")

    def _post_status(
        self,
        pod: v1.Pod,
        phase: str,
        ip: Optional[str],
        ready: Optional[bool] = None,
    ) -> None:
        def mutate(p):
            if p.status.phase in (v1.POD_SUCCEEDED, v1.POD_FAILED):
                # never regress a terminal phase (a stale watch snapshot
                # racing a completed pod must not flip it back to Running)
                return None
            if (
                p.status.phase == phase
                and (ip is None or p.status.pod_ip == ip)
                and ready is None
            ):
                return None
            p.status.phase = phase
            if p.status.start_time is None:
                p.status.start_time = time.time()
            if ip is not None:
                p.status.pod_ip = ip
                p.status.host_ip = self.host_ip or ip
            if ready is not None:
                status = "True" if ready else "False"
                for c in p.status.conditions:
                    if c.type == v1.COND_POD_READY:
                        c.status = status
                        break
                else:
                    p.status.conditions.append(
                        v1.PodCondition(type=v1.COND_POD_READY, status=status)
                    )
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("pod_status")

    # -- heartbeats (pkg/kubelet/nodelease) ----------------------------------

    # lease-renewal retry budget on retryable 503s (DegradedWrites): a
    # transient degraded blip must not silently drop the renewal — that is
    # how a control-plane outage turns into false NotReady → eviction.
    # Both attempt- AND time-bounded; a persistent in-process outage bails
    # even faster via write-gate introspection. NOTE the budget only gates
    # BETWEEN attempts: a RESTClient burns its own Retry-After sleeps
    # (~3 s at defaults) INSIDE each call before DegradedWrites surfaces,
    # which this loop cannot shorten — a REST-backed pool that must not
    # stall its serial heartbeat sweep should wire the heartbeat path
    # with degraded_retries=0 and let this loop own the retry policy.
    heartbeat_retries: int = 3
    heartbeat_retry_budget_s: float = 0.5

    def heartbeat(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()

        def renew(lease):
            lease.renew_time = now
            return lease

        delay = 0.05
        deadline = time.monotonic() + self.heartbeat_retry_budget_s
        for attempt in range(self.heartbeat_retries + 1):
            try:
                self.server.guaranteed_update(
                    "leases", NODE_LEASE_NS, self.node_name, renew
                )
                return
            except (NotFound, Conflict):
                return
            except NotPrimary:
                # fenced ex-primary: permanent for that endpoint — never
                # retry against it (callers re-point the pool at the new
                # leader); dropping the renewal must not kill the SHARED
                # heartbeat thread
                metrics.inc("kubelet_heartbeat_renewals_dropped_total")
                return
            except DegradedWrites:
                gate = getattr(self.server, "write_gate", None)
                if (
                    attempt >= self.heartbeat_retries
                    or time.monotonic() >= deadline
                    or (gate is not None and getattr(gate, "degraded", False))
                ):
                    # store still read-only: this renewal is dropped (the
                    # next beat retries); nodelifecycle's partial-disruption
                    # threshold covers the fleet-wide staleness this causes
                    metrics.inc("kubelet_heartbeat_renewals_dropped_total")
                    return
                metrics.inc("kubelet_heartbeat_retries_total")
                time.sleep(delay + random.uniform(0, delay))
                delay = min(delay * 2, 0.2)

    def _post_admission_failure(self, pod: v1.Pod, message: str) -> None:
        """UnexpectedAdmissionError (the reference's device-admission
        failure phase): the pod fails on this node; a controller replaces
        it and the scheduler tries elsewhere."""

        def mutate(p):
            p.status.phase = v1.POD_FAILED
            p.status.reason = "UnexpectedAdmissionError"
            p.status.message = message
            return p

        try:
            self.server.guaranteed_update(
                "pods", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("admission_failure")

    def sync_device_capacity(self) -> None:
        """Surface plugin resources into NodeStatus capacity/allocatable
        (manager.go GetCapacity -> node status setters). Cheap no-op until
        the manager's device set actually changes."""
        dm = self.device_manager
        if dm is None or dm.generation == self._device_generation:
            return
        gen = dm.generation
        caps = dm.capacities()

        def mutate(node):
            changed = False
            for res, cnt in caps.items():
                if node.status.capacity.get(res) != cnt:
                    node.status.capacity[res] = cnt
                    node.status.allocatable[res] = cnt
                    changed = True
            return node if changed else None

        try:
            self.server.guaranteed_update("nodes", "", self.node_name, mutate)
            self._device_generation = gen
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("device_capacity")

    def sync_node_allocatable(self) -> None:
        """Post allocatable = capacity - reservations (container_manager's
        Node Allocatable math; cm/container_manager_linux.go) once — the
        reservations are static for the kubelet's lifetime."""
        cm = self.container_manager
        if cm is None or self._allocatable_synced:
            return

        def mutate(node):
            alloc = cm.node_allocatable(node.status.capacity)
            if node.status.allocatable == alloc:
                return None
            node.status.allocatable = alloc
            return node

        try:
            self.server.guaranteed_update("nodes", "", self.node_name, mutate)
            self._allocatable_synced = True
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("node_allocatable")

    def post_ready_condition(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()

        def mutate(node):
            for c in node.status.conditions:
                if c.type == v1.NODE_READY:
                    c.status = "True"
                    c.last_heartbeat_time = now
                    return node
            node.status.conditions.append(
                v1.NodeCondition(type=v1.NODE_READY, status="True")
            )
            return node

        try:
            self.server.guaranteed_update("nodes", "", self.node_name, mutate)
        except NotFound:
            pass
        except DegradedWrites:
            skip_degraded_write("ready_condition")


class NodeAgentPool:
    """Run many Kubelets on shared threads: one pod-watch dispatcher, one
    heartbeat loop, one housekeeping (PLEG) loop. The kubemark trick of
    multiplexing hollow nodes in-process — with the REAL kubelet sync code."""

    def __init__(
        self,
        server,
        heartbeat_interval: float = 10.0,
        housekeeping_interval: float = 0.5,
        runtime_factory: Optional[Callable[[str], PodRuntime]] = None,
    ):
        self.server = server
        self.heartbeat_interval = heartbeat_interval
        self.housekeeping_interval = housekeeping_interval
        self.kubelets: Dict[str, Kubelet] = {}
        self._runtime_factory = runtime_factory or self._default_runtime
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        # the node-side service dataplane (kube-proxy-lite): one shared
        # Proxier per pool — the table has no per-node state in this build,
        # mirroring kubemark's HollowProxy sharing one iptables interface
        from ..proxy import Proxier

        self.proxy = Proxier(server)

    @staticmethod
    def _default_runtime(node_name: str) -> PodRuntime:
        from ..kubemark.hollow_node import _fake_pod_ip

        return FakeRuntime(_fake_pod_ip)

    # -- membership ----------------------------------------------------------

    def add_node(self, name: str, register: bool = True, **node_kw) -> Kubelet:  # graftlint: degraded-ok(node registration must surface: the caller owns the retry — silently skipping would hand out a Kubelet for a node the store never saw)
        if register:
            self.server.create("nodes", make_node_object(name, **node_kw))
            try:
                self.server.create(
                    "leases",
                    Lease(
                        metadata=v1.ObjectMeta(name=name, namespace=NODE_LEASE_NS),
                        holder_identity=name,
                        lease_duration_seconds=40.0,
                        renew_time=time.time(),
                    ),
                )
            except Exception:
                pass
        from ..kubemark.hollow_node import _fake_pod_ip

        kl = Kubelet(
            self.server,
            name,
            self._runtime_factory(name),
            host_ip=_fake_pod_ip(name),
        )
        with self._lock:
            self.kubelets[name] = kl
        # surface the node's logs/exec to the apiserver (kubectl logs/exec
        # hop); remote clients (joined pools) have no provider registry
        providers = getattr(self.server, "log_providers", None)
        if providers is not None:
            providers[name] = kl.runtime.logs
        execs = getattr(self.server, "exec_providers", None)
        if execs is not None:
            execs[name] = kl.runtime.exec
        return kl

    def remove_node(self, name: str) -> None:
        """Stop the node's agent (the node 'dies'; object stays for
        nodelifecycle to notice the missed heartbeats)."""
        with self._lock:
            self.kubelets.pop(name, None)
        for attr in ("log_providers", "exec_providers"):
            providers = getattr(self.server, attr, None)
            if providers is not None:
                providers.pop(name, None)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for target, name in (
            (self._watch_loop, "kubelet-watch"),
            (self._heartbeat_loop, "kubelet-heartbeat"),
            (self._housekeeping_loop, "kubelet-pleg"),
        ):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        self.proxy.start()

    def stop(self) -> None:
        self._stop.set()
        self.proxy.stop()

    # -- shared loops --------------------------------------------------------

    def _kubelet_for(self, pod: v1.Pod) -> Optional[Kubelet]:
        with self._lock:
            return self.kubelets.get(pod.spec.node_name)

    def _watch_loop(self) -> None:
        from ..client.apiserver import list_and_watch

        def dispatch(ev_type: str, pod: v1.Pod) -> None:
            kl = self._kubelet_for(pod)
            if kl is None:
                return
            try:
                kl.handle_pod_event(ev_type, pod)
            except Exception:
                # a status write 503ing against a degraded store (or any
                # per-pod failure) must not kill the SHARED watch loop —
                # the PLEG relist reconciles the missed transition
                logger.exception(
                    "pod event %s for %s failed on node %s",
                    ev_type, pod.metadata.key, pod.spec.node_name,
                )

        def seed(pods):
            for pod in pods:
                dispatch("ADDED", pod)

        watcher = list_and_watch(self.server, "pods", seed)
        while not self._stop.is_set():
            ev = watcher.get(timeout=0.2)
            if ev is None or ev.type == BOOKMARK:
                # bookmarks are rv-only progress notifies from the watch
                # cache — no pod state to sync
                continue
            dispatch(ev.type, ev.object)
        watcher.stop()

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            now = time.time()
            with self._lock:
                kls = list(self.kubelets.values())
            for kl in kls:
                if self._stop.is_set():
                    return
                try:
                    kl.heartbeat(now)
                except Exception:
                    # one node's renewal failure (unexpected transport
                    # error, fenced store, ...) must not kill the SHARED
                    # heartbeat thread for the whole pool — that would
                    # manufacture the mass-NotReady cascade this layer
                    # exists to prevent
                    logger.exception("heartbeat failed for %s", kl.node_name)
            self._stop.wait(self.heartbeat_interval)

    def _housekeeping_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                kls = list(self.kubelets.values())
            for kl in kls:
                if self._stop.is_set():
                    return
                try:
                    kl.housekeeping()
                except Exception:
                    logger.exception("housekeeping failed for %s", kl.node_name)
            self._stop.wait(self.housekeeping_interval)
