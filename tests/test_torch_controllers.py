"""The controllers of the port (kubernetes_tpu_torch/controller/, copies
of the reference's) held to the reference's own controller tests: the
workload controllers (Deployment, ReplicaSet, Job, DaemonSet, StatefulSet,
CronJob), the newer ones (HPA, TTL, PodGC, endpoint slices, node IPAM,
cron schedules), the garbage collector and deletion protection, RBAC
aggregation and the bootstrap signers, the cloud controllers, the storage
and network controllers, and the disruption budgets that preemption
honours. Each section below is the reference file named in its heading,
with its imports pointed at the port and every Scheduler at
device="cpu". Helpers that two reference files define differently carry
the file's tag. test_preemption_pdb.py's what-if mask case drives the
reference's JAX lattice directly; its port is the what-if parity of
tests/test_torch_preemption.py and it is left out here. Tolerances:
exact.
"""

# -- tests/test_workload_controllers.py --------------------------------
# Workload controllers end-to-end: Deployment rolling update, Job
# completion/backoff, DaemonSet per-node placement, StatefulSet ordered
# rollout, Endpoints publication, PDB disruption accounting — driven with the
# real scheduler + hollow nodes (the reference's integration-test topology:
# real controllers, no real kubelets).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.daemonset import DaemonSetController
from kubernetes_tpu_torch.controller.deployment import DeploymentController, template_hash
from kubernetes_tpu_torch.controller.disruption import DisruptionController
from kubernetes_tpu_torch.controller.endpoints import EndpointsController
from kubernetes_tpu_torch.controller.job import JobController
from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
from kubernetes_tpu_torch.controller.statefulset import StatefulSetController
from kubernetes_tpu_torch.kubemark import HollowCluster
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler


def wait_until(fn, timeout=25.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def _template_wl(labels, cpu="100m", image="app:v1"):
    return v1.PodTemplateSpec(
        metadata=v1.ObjectMeta(labels=dict(labels)),
        spec=v1.PodSpec(
            containers=[v1.Container(image=image, requests={"cpu": cpu})]
        ),
    )


class _Cluster:
    """Scheduler + hollow nodes + a chosen set of controllers."""

    def __init__(self, num_nodes=4, controllers=()):
        self.server = APIServer()
        self.hollow = HollowCluster(self.server, num_nodes=num_nodes)
        self.sched = Scheduler(self.server, KubeSchedulerConfiguration(), device="cpu")
        self.controllers = list(controllers)

    def __enter__(self):
        self.hollow.start()
        self.sched.start()
        for c in self.controllers:
            c.start()
        return self

    def __exit__(self, *exc):
        for c in self.controllers:
            c.stop()
        self.sched.stop()
        self.hollow.stop()


def test_deployment_rollout_and_rolling_update():
    server = APIServer()
    cl = _Cluster(num_nodes=4)
    cl.controllers = [
        DeploymentController(cl.server),
        ReplicaSetController(cl.server),
    ]
    with cl:
        server = cl.server
        dep = v1.Deployment(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.DeploymentSpec(
                replicas=3,
                selector={"app": "web"},
                template=_template_wl({"app": "web"}),
                strategy=v1.DeploymentStrategy(max_surge=1, max_unavailable=1),
            ),
        )
        server.create("deployments", dep)
        assert wait_until(
            lambda: sum(
                1
                for p in server.list("pods")[0]
                if p.status.phase == "Running"
            )
            == 3
        ), [(p.metadata.name, p.status.phase) for p in server.list("pods")[0]]
        rss, _ = server.list("replicasets")
        assert len(rss) == 1
        h1 = template_hash(dep.spec.template)
        assert rss[0].metadata.labels["pod-template-hash"] == h1

        # rolling update: change the image
        def bump(cur):
            cur.spec.template.spec.containers[0].image = "app:v2"
            return cur

        server.guaranteed_update("deployments", "default", "web", bump)

        def updated():
            pods, _ = server.list("pods")
            v2 = [
                p
                for p in pods
                if p.status.phase == "Running"
                and p.spec.containers[0].image == "app:v2"
            ]
            v1_pods = [
                p for p in pods if p.spec.containers[0].image == "app:v1"
            ]
            return len(v2) == 3 and not v1_pods

        assert wait_until(updated, timeout=30), [
            (p.metadata.name, p.spec.containers[0].image, p.status.phase)
            for p in server.list("pods")[0]
        ]
        dep2 = server.get("deployments", "default", "web")
        assert wait_until(
            lambda: server.get("deployments", "default", "web").status.ready_replicas
            == 3
        )
        assert dep2.spec.replicas == 3

        # scale down: the (sole) new RS must shrink too
        def shrink(cur):
            cur.spec.replicas = 1
            return cur

        server.guaranteed_update("deployments", "default", "web", shrink)
        assert wait_until(
            lambda: sum(
                1 for p in server.list("pods")[0] if p.status.phase == "Running"
            )
            == 1,
            timeout=30,
        ), [(p.metadata.name, p.status.phase) for p in server.list("pods")[0]]


def test_job_runs_to_completion():
    server = APIServer()
    ctrl = JobController(server)
    ctrl.start()
    try:
        job = v1.Job(
            metadata=v1.ObjectMeta(name="crunch"),
            spec=v1.JobSpec(
                parallelism=2,
                completions=3,
                template=_template_wl({"job": "crunch"}),
            ),
        )
        server.create("jobs", job)
        assert wait_until(lambda: len(server.list("pods")[0]) == 2)

        # succeed pods as they appear until the job completes
        def succeed_all():
            for p in server.list("pods")[0]:
                if p.status.phase not in ("Succeeded", "Failed"):
                    def fin(cur):
                        cur.status.phase = "Succeeded"
                        return cur

                    server.guaranteed_update(
                        "pods", p.metadata.namespace, p.metadata.name, fin
                    )
            j = server.get("jobs", "default", "crunch")
            return any(
                c.type == "Complete" and c.status == "True"
                for c in j.status.conditions
            )

        assert wait_until(succeed_all, timeout=20)
        j = server.get("jobs", "default", "crunch")
        assert j.status.succeeded == 3
        assert j.status.completion_time is not None
    finally:
        ctrl.stop()


def test_job_backoff_limit_fails_job():
    server = APIServer()
    ctrl = JobController(server)
    ctrl.start()
    try:
        job = v1.Job(
            metadata=v1.ObjectMeta(name="flaky"),
            spec=v1.JobSpec(
                parallelism=1,
                completions=1,
                backoff_limit=1,
                template=_template_wl({"job": "flaky"}),
            ),
        )
        server.create("jobs", job)

        def fail_active():
            for p in server.list("pods")[0]:
                if p.status.phase not in ("Succeeded", "Failed"):
                    def fin(cur):
                        cur.status.phase = "Failed"
                        return cur

                    server.guaranteed_update(
                        "pods", p.metadata.namespace, p.metadata.name, fin
                    )
            j = server.get("jobs", "default", "flaky")
            return any(
                c.type == "Failed" and c.status == "True"
                for c in j.status.conditions
            )

        assert wait_until(fail_active, timeout=20)
    finally:
        ctrl.stop()


def test_daemonset_places_one_pod_per_eligible_node():
    cl = _Cluster(num_nodes=3)
    cl.controllers = [DaemonSetController(cl.server)]
    with cl:
        server = cl.server
        # taint one node; the DS template has no toleration for it
        def taint(cur):
            cur.spec.taints = [v1.Taint("dedicated", "infra", "NoSchedule")]
            return cur

        server.guaranteed_update("nodes", "", "hollow-node-2", taint)
        ds = v1.DaemonSet(
            metadata=v1.ObjectMeta(name="agent"),
            spec=v1.DaemonSetSpec(
                selector={"app": "agent"},
                template=_template_wl({"app": "agent"}, cpu="10m"),
            ),
        )
        server.create("daemonsets", ds)

        def placed():
            pods, _ = server.list("pods")
            nodes = {p.spec.node_name for p in pods if p.spec.node_name}
            return len(pods) == 2 and nodes == {
                "hollow-node-0",
                "hollow-node-1",
            }

        assert wait_until(placed), [
            (p.metadata.name, p.spec.node_name)
            for p in server.list("pods")[0]
        ]
        # a new node grows the daemon set
        cl.hollow.add_node("hollow-node-3")
        assert wait_until(
            lambda: any(
                p.spec.node_name == "hollow-node-3"
                for p in server.list("pods")[0]
            )
        )
        st = server.get("daemonsets", "default", "agent")
        assert wait_until(
            lambda: server.get(
                "daemonsets", "default", "agent"
            ).status.desired_number_scheduled
            == 3
        )


def test_statefulset_ordered_rollout_and_scale_down():
    cl = _Cluster(num_nodes=3)
    cl.controllers = [StatefulSetController(cl.server)]
    with cl:
        server = cl.server
        st = v1.StatefulSet(
            metadata=v1.ObjectMeta(name="db"),
            spec=v1.StatefulSetSpec(
                replicas=3,
                selector={"app": "db"},
                template=_template_wl({"app": "db"}),
                service_name="db",
            ),
        )
        server.create("statefulsets", st)
        assert wait_until(
            lambda: sorted(
                p.metadata.name
                for p in server.list("pods")[0]
                if p.status.phase == "Running"
            )
            == ["db-0", "db-1", "db-2"],
            timeout=30,
        ), [
            (p.metadata.name, p.status.phase)
            for p in server.list("pods")[0]
        ]

        def shrink(cur):
            cur.spec.replicas = 1
            return cur

        server.guaranteed_update("statefulsets", "default", "db", shrink)
        assert wait_until(
            lambda: sorted(
                p.metadata.name for p in server.list("pods")[0]
            )
            == ["db-0"],
            timeout=30,
        )


def test_endpoints_publishes_ready_pod_addresses():
    cl = _Cluster(num_nodes=2)
    cl.controllers = [
        EndpointsController(cl.server),
        ReplicaSetController(cl.server),
    ]
    with cl:
        server = cl.server
        server.create(
            "services",
            v1.Service(
                metadata=v1.ObjectMeta(name="web"),
                spec=v1.ServiceSpec(
                    selector={"app": "web"}, ports=[("http", 80)]
                ),
            ),
        )
        rs = v1.ReplicaSet(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.ReplicaSetSpec(
                replicas=2,
                selector={"app": "web"},
                template=_template_wl({"app": "web"}),
            ),
        )
        server.create("replicasets", rs)

        def published():
            try:
                ep = server.get("endpoints", "default", "web")
            except KeyError:
                return False
            return (
                len(ep.subsets) == 1
                and len(ep.subsets[0].addresses) == 2
                and all(a.ip for a in ep.subsets[0].addresses)
                and ep.subsets[0].ports == [("http", 80)]
            )

        assert wait_until(published), server.list("endpoints")[0]


def test_disruption_controller_budget_accounting():
    cl = _Cluster(num_nodes=3)
    cl.controllers = [
        DisruptionController(cl.server),
        ReplicaSetController(cl.server),
    ]
    with cl:
        server = cl.server
        rs = v1.ReplicaSet(
            metadata=v1.ObjectMeta(name="quorum"),
            spec=v1.ReplicaSetSpec(
                replicas=3,
                selector={"app": "quorum"},
                template=_template_wl({"app": "quorum"}),
            ),
        )
        server.create("replicasets", rs)
        pdb = v1.PodDisruptionBudget(
            metadata=v1.ObjectMeta(name="quorum-pdb"),
            spec=v1.PodDisruptionBudgetSpec(
                min_available=2, selector={"app": "quorum"}
            ),
        )
        server.create("poddisruptionbudgets", pdb)

        def budgeted():
            p = server.get("poddisruptionbudgets", "default", "quorum-pdb")
            return (
                p.status.current_healthy == 3
                and p.status.desired_healthy == 2
                and p.status.disruptions_allowed == 1
                and p.status.expected_pods == 3
            )

        assert wait_until(budgeted), server.get(
            "poddisruptionbudgets", "default", "quorum-pdb"
        ).status


# -- tests/test_new_controllers.py -------------------------------------
# HPA, CronJob, ResourceQuota, ServiceAccount, TTL(+AfterFinished)
# controllers — the round-3 controller-breadth slice (reference list:
# cmd/kube-controller-manager/app/controllermanager.go:372-414).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.cronjob import CronJobController
from kubernetes_tpu_torch.controller.hpa import CPU_USAGE_ANNOTATION, HPAController
from kubernetes_tpu_torch.controller.job import JobController
from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
from kubernetes_tpu_torch.controller.resourcequota import ResourceQuotaController
from kubernetes_tpu_torch.controller.serviceaccount import (
    TOKEN_SECRET_TYPE,
    ServiceAccountController,
)
from kubernetes_tpu_torch.controller.ttl import (
    TTL_ANNOTATION,
    TTLAfterFinishedController,
    TTLController,
    ttl_for_cluster_size,
)
from kubernetes_tpu_torch.utils.cron import CronSchedule


def wait_until_new(fn, timeout=60.0, period=0.05):
    # generous: full-suite runs share the box with XLA compiles and leaked
    # daemon threads from earlier tests; 25s showed rare flakes under load
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def _template_new(labels, cpu="100m"):
    return v1.PodTemplateSpec(
        metadata=v1.ObjectMeta(labels=dict(labels)),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
    )


# ---------------------------------------------------------------------------
# cron parser
# ---------------------------------------------------------------------------


def test_cron_schedule_parsing_and_next():
    s = CronSchedule("*/15 * * * *")
    t0 = time.mktime((2026, 7, 29, 10, 3, 0, 0, 0, -1))
    nxt = time.localtime(s.next_after(t0))
    assert (nxt.tm_hour, nxt.tm_min) == (10, 15)
    s2 = CronSchedule("30 2 * * *")
    nxt2 = time.localtime(s2.next_after(t0))
    assert (nxt2.tm_hour, nxt2.tm_min) == (2, 30)
    # every minute fires next minute
    s3 = CronSchedule("* * * * *")
    assert s3.next_after(t0) - t0 <= 60


# ---------------------------------------------------------------------------
# HPA
# ---------------------------------------------------------------------------


def test_hpa_scales_deployment_up_and_down():
    server = APIServer()
    server.create(
        "deployments",
        v1.Deployment(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.DeploymentSpec(
                replicas=2, selector={"app": "web"}, template=_template_new({"app": "web"})
            ),
        ),
    )
    # two pods at 180m usage each against 100m requests -> 180% of the 60%
    # target -> desired = ceil(2 * 180/60) = 6, clamped to max 5
    for i in range(2):
        server.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(
                    name=f"web-{i}",
                    labels={"app": "web"},
                    annotations={CPU_USAGE_ANNOTATION: "180m"},
                ),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
            ),
        )
    server.create(
        "horizontalpodautoscalers",
        v1.HorizontalPodAutoscaler(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.HorizontalPodAutoscalerSpec(
                scale_target_ref=v1.CrossVersionObjectReference(
                    kind="Deployment", name="web"
                ),
                min_replicas=1,
                max_replicas=5,
                target_cpu_utilization_percentage=60,
            ),
        ),
    )
    hpa = HPAController(server, sync_period=0.2)
    hpa.start()
    try:
        assert wait_until_new(
            lambda: server.get("deployments", "default", "web").spec.replicas == 5
        ), "hpa must scale up to max"
        st = server.get("horizontalpodautoscalers", "default", "web").status
        assert st.desired_replicas == 5
        assert st.current_cpu_utilization_percentage == 180
        # drop usage to 6m -> 6% of target 60% -> scale down to min
        for i in range(2):
            def mutate(p):
                p.metadata.annotations[CPU_USAGE_ANNOTATION] = "6m"
                return p

            server.guaranteed_update("pods", "default", f"web-{i}", mutate)
        assert wait_until_new(
            lambda: server.get("deployments", "default", "web").spec.replicas == 1
        ), "hpa must scale down to min"
    finally:
        hpa.stop()


def test_hpa_within_tolerance_no_scale():
    server = APIServer()
    server.create(
        "deployments",
        v1.Deployment(
            metadata=v1.ObjectMeta(name="calm"),
            spec=v1.DeploymentSpec(
                replicas=2,
                selector={"app": "calm"},
                template=_template_new({"app": "calm"}),
            ),
        ),
    )
    for i in range(2):
        server.create(
            "pods",
            v1.Pod(
                metadata=v1.ObjectMeta(
                    name=f"calm-{i}",
                    labels={"app": "calm"},
                    annotations={CPU_USAGE_ANNOTATION: "63m"},  # 63% vs 60% target
                ),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
            ),
        )
    server.create(
        "horizontalpodautoscalers",
        v1.HorizontalPodAutoscaler(
            metadata=v1.ObjectMeta(name="calm"),
            spec=v1.HorizontalPodAutoscalerSpec(
                scale_target_ref=v1.CrossVersionObjectReference(
                    kind="Deployment", name="calm"
                ),
                min_replicas=1,
                max_replicas=5,
                target_cpu_utilization_percentage=60,
            ),
        ),
    )
    hpa = HPAController(server, sync_period=0.1)
    hpa.start()
    try:
        assert wait_until_new(
            lambda: server.get(
                "horizontalpodautoscalers", "default", "calm"
            ).status.observed_generation
            >= 0
            and server.get(
                "horizontalpodautoscalers", "default", "calm"
            ).status.current_cpu_utilization_percentage
            is not None
        )
        time.sleep(0.5)
        assert server.get("deployments", "default", "calm").spec.replicas == 2, (
            "within +/-10% tolerance the HPA must not scale"
        )
    finally:
        hpa.stop()


# ---------------------------------------------------------------------------
# CronJob
# ---------------------------------------------------------------------------


def test_cronjob_spawns_job_and_tracks_history():
    server = APIServer()
    cj = v1.CronJob(
        metadata=v1.ObjectMeta(name="tick"),
        spec=v1.CronJobSpec(
            schedule="* * * * *",
            job_template=v1.JobTemplateSpec(
                spec=v1.JobSpec(completions=1, template=_template_new({"app": "tick"}))
            ),
        ),
    )
    # anchor creation in the past so a schedule is already due
    cj.metadata.creation_timestamp = time.time() - 120
    server.create("cronjobs", cj)
    ctrl = CronJobController(server, sync_period=0.2)
    ctrl.start()
    try:
        assert wait_until_new(lambda: len(server.list("jobs")[0]) >= 1), (
            "cronjob must spawn a job for the due schedule"
        )
        job = server.list("jobs")[0][0]
        assert job.metadata.name.startswith("tick-")
        assert any(
            r.kind == "CronJob" and r.controller
            for r in job.metadata.owner_references
        )
        cur = server.get("cronjobs", "default", "tick")
        assert cur.status.last_schedule_time is not None
    finally:
        ctrl.stop()


def test_cronjob_forbid_concurrency():
    server = APIServer()
    cj = v1.CronJob(
        metadata=v1.ObjectMeta(name="serial"),
        spec=v1.CronJobSpec(
            schedule="* * * * *",
            concurrency_policy="Forbid",
            job_template=v1.JobTemplateSpec(
                spec=v1.JobSpec(completions=1, template=_template_new({"app": "s"}))
            ),
        ),
    )
    cj.metadata.creation_timestamp = time.time() - 120
    server.create("cronjobs", cj)
    ctrl = CronJobController(server, sync_period=0.1)
    ctrl.start()
    try:
        assert wait_until_new(lambda: len(server.list("jobs")[0]) == 1)
        # active job never finishes (no kubelet); Forbid must not spawn more
        time.sleep(1.0)
        assert len(server.list("jobs")[0]) == 1
    finally:
        ctrl.stop()


# ---------------------------------------------------------------------------
# ResourceQuota
# ---------------------------------------------------------------------------


def test_resourcequota_status_tracks_usage():
    server = APIServer()
    server.create(
        "resourcequotas",
        v1.ResourceQuota(
            metadata=v1.ObjectMeta(name="q"),
            spec=v1.ResourceQuotaSpec(
                hard={"pods": 10, "requests.cpu": 4000, "requests.memory": 2**33}
            ),
        ),
    )
    ctrl = ResourceQuotaController(server, resync_period=0.5)
    ctrl.start()
    try:
        for i in range(3):
            server.create(
                "pods",
                v1.Pod(
                    metadata=v1.ObjectMeta(name=f"q-{i}"),
                    spec=v1.PodSpec(
                        containers=[
                            v1.Container(requests={"cpu": "500m", "memory": "1Gi"})
                        ]
                    ),
                ),
            )
        def used_ok():
            st = server.get("resourcequotas", "default", "q").status
            return st.used.get("pods") == 3 and st.used.get("requests.cpu") == 1500

        assert wait_until_new(used_ok), "quota status must track namespace usage"
    finally:
        ctrl.stop()


# ---------------------------------------------------------------------------
# ServiceAccount + token
# ---------------------------------------------------------------------------


def test_serviceaccount_default_sa_and_token():
    server = APIServer()
    server.create("namespaces", v1.Namespace(metadata=v1.ObjectMeta(name="team-a")))
    ctrl = ServiceAccountController(server)
    ctrl.start()
    try:
        assert wait_until_new(
            lambda: any(
                sa.metadata.name == "default"
                for sa in server.list("serviceaccounts", namespace="team-a")[0]
            )
        ), "default ServiceAccount must be created per namespace"

        def token_ok():
            try:
                sa = server.get("serviceaccounts", "team-a", "default")
                sec = server.get("secrets", "team-a", "default-token")
            except KeyError:
                return False
            return sec.type == TOKEN_SECRET_TYPE and "default-token" in sa.secrets

        assert wait_until_new(token_ok), "token secret must exist and be referenced"
    finally:
        ctrl.stop()


# ---------------------------------------------------------------------------
# TTL + TTLAfterFinished
# ---------------------------------------------------------------------------


def test_ttl_boundaries():
    assert ttl_for_cluster_size(10) == 0
    assert ttl_for_cluster_size(101) == 15
    assert ttl_for_cluster_size(501) == 30
    assert ttl_for_cluster_size(5000) == 60


def test_ttl_controller_annotates_nodes():
    server = APIServer()
    for i in range(3):
        server.create(
            "nodes",
            v1.Node(metadata=v1.ObjectMeta(name=f"n{i}"), spec=v1.NodeSpec()),
        )
    ctrl = TTLController(server)
    ctrl.start()
    try:
        assert wait_until_new(
            lambda: all(
                n.metadata.annotations.get(TTL_ANNOTATION) == "0"
                for n in server.list("nodes")[0]
            )
        )
    finally:
        ctrl.stop()


def test_ttl_after_finished_deletes_job():
    server = APIServer()
    job = v1.Job(
        metadata=v1.ObjectMeta(name="done"),
        spec=v1.JobSpec(
            completions=1,
            ttl_seconds_after_finished=1,
            template=_template_new({"app": "done"}),
        ),
    )
    job.status.conditions.append(
        v1.PodCondition(type="Complete", status="True")
    )
    server.create("jobs", job)
    ctrl = TTLAfterFinishedController(server, tick=0.2)
    ctrl.start()
    try:
        assert wait_until_new(
            lambda: not any(
                j.metadata.name == "done" for j in server.list("jobs")[0]
            ),
            timeout=15,
        ), "finished job must be GC'd after its TTL"
    finally:
        ctrl.stop()


# ---------------------------------------------------------------------------
# HPA drives scale-up bursts into the scheduler (VERDICT item 8's ask)
# ---------------------------------------------------------------------------


def test_hpa_scaleup_burst_flows_through_scheduler():
    from kubernetes_tpu_torch.kubemark import HollowCluster
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler

    server = APIServer()
    hollow = HollowCluster(server, num_nodes=4)
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    rs = ReplicaSetController(server)
    hpa = HPAController(server, sync_period=0.2)
    hollow.start()
    sched.start()
    rs.start()
    hpa.start()
    try:
        server.create(
            "replicasets",
            v1.ReplicaSet(
                metadata=v1.ObjectMeta(name="burst"),
                spec=v1.ReplicaSetSpec(
                    replicas=2,
                    selector={"app": "burst"},
                    template=_template_new({"app": "burst"}),
                ),
            ),
        )
        # wait for the initial 2, annotate them hot, watch HPA fan out to 8
        # and every new pod get scheduled + run
        assert wait_until_new(
            lambda: sum(
                1
                for p in server.list("pods")[0]
                if p.spec.node_name and p.metadata.labels.get("app") == "burst"
            )
            >= 2,
            timeout=60,
        )
        for p in server.list("pods")[0]:
            if p.metadata.labels.get("app") == "burst":
                def hot(cur):
                    cur.metadata.annotations[CPU_USAGE_ANNOTATION] = "400m"
                    return cur

                server.guaranteed_update(
                    "pods", p.metadata.namespace, p.metadata.name, hot
                )
        server.create(
            "horizontalpodautoscalers",
            v1.HorizontalPodAutoscaler(
                metadata=v1.ObjectMeta(name="burst"),
                spec=v1.HorizontalPodAutoscalerSpec(
                    scale_target_ref=v1.CrossVersionObjectReference(
                        kind="ReplicaSet", name="burst"
                    ),
                    min_replicas=2,
                    max_replicas=8,
                    target_cpu_utilization_percentage=50,
                ),
            ),
        )
        assert wait_until_new(
            lambda: sum(
                1
                for p in server.list("pods")[0]
                if p.spec.node_name and p.metadata.labels.get("app") == "burst"
            )
            >= 8,
            timeout=90,
        ), "HPA burst must scale out and schedule"
    finally:
        hpa.stop()
        rs.stop()
        sched.stop()
        hollow.stop()


def test_serviceaccount_deletion_revokes_token():
    """Deleting an SA must delete its token secret (the credential revokes)."""
    server = APIServer()
    server.create("namespaces", v1.Namespace(metadata=v1.ObjectMeta(name="rm")))
    ctrl = ServiceAccountController(server)
    ctrl.start()
    try:
        assert wait_until_new(
            lambda: any(
                s.type == TOKEN_SECRET_TYPE
                for s in server.list("secrets", namespace="rm")[0]
            )
        )
        server.delete("serviceaccounts", "rm", "default")
        # the controller recreates default + token, but the OLD secret must
        # have been GC'd in between; force the explicit orphan case:
        # create a token secret for an SA that never existed
        server.create(
            "secrets",
            v1.Secret(
                metadata=v1.ObjectMeta(
                    name="ghost-token",
                    namespace="rm",
                    annotations={"kubernetes.io/service-account.name": "ghost"},
                ),
                type=TOKEN_SECRET_TYPE,
                data={"token": b"zombie"},
            ),
        )
        assert wait_until_new(
            lambda: not any(
                s.metadata.name == "ghost-token"
                for s in server.list("secrets", namespace="rm")[0]
            )
        ), "orphaned token secret must be deleted"
    finally:
        ctrl.stop()


def test_cron_next_after_non_whole_hour_timezone():
    """Hour jumps must land on LOCAL hour boundaries (+5:30 zones)."""
    import os
    import subprocess
    import sys

    code = (
        "import time; from kubernetes_tpu_torch.utils.cron import CronSchedule; "
        "s = CronSchedule('0 5 * * *'); "
        "t = s.next_after(time.time()); "
        "tm = time.localtime(t); "
        "assert (tm.tm_hour, tm.tm_min) == (5, 0), (tm.tm_hour, tm.tm_min); "
        "print('TZ_OK')"
    )
    env = dict(os.environ, TZ="Asia/Kolkata")
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        timeout=60,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0 and "TZ_OK" in r.stdout, r.stderr[-500:]


# -- tests/test_controllers.py -----------------------------------------
# Controllers + hollow nodes: ReplicaSet reconcile, GC cascade, node
# failure detection/eviction, namespace drain — driven end-to-end with the
# real scheduler and hollow kubelets (the reference's kubemark topology).
import time

import pytest

from kubernetes_tpu_torch.api.objects import (
    Container,
    Namespace,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicaSet,
    ReplicaSetSpec,
)
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.controller.manager import ControllerManager
from kubernetes_tpu_torch.controller.namespace import NamespaceController
from kubernetes_tpu_torch.controller.nodelifecycle import (
    TAINT_UNREACHABLE,
    NodeLifecycleController,
)
from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
from kubernetes_tpu_torch.kubemark import HollowCluster
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler


def make_rs(name, replicas=3):
    return ReplicaSet(
        metadata=ObjectMeta(name=name),
        spec=ReplicaSetSpec(
            replicas=replicas,
            selector={"app": name},
            template=PodTemplateSpec(
                metadata=ObjectMeta(labels={"app": name}),
                spec=PodSpec(
                    containers=[Container(requests={"cpu": "100m"})]
                ),
            ),
        ),
    )


def wait_until_ctrl(fn, timeout=20.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def test_replicaset_scales_and_hollow_nodes_run_pods():
    server = APIServer()
    hollow = HollowCluster(server, num_nodes=4)
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    rs_ctrl = ReplicaSetController(server)
    hollow.start()
    sched.start()
    rs_ctrl.start()
    try:
        server.create("replicasets", make_rs("web", replicas=3))
        assert wait_until_ctrl(
            lambda: sum(
                1
                for p in server.list("pods")[0]
                if p.spec.node_name and p.status.phase == "Running"
            )
            == 3
        ), [
            (p.metadata.name, p.spec.node_name, p.status.phase)
            for p in server.list("pods")[0]
        ]

        # scale down to 1
        def scale(rs):
            rs.spec.replicas = 1
            return rs

        server.guaranteed_update("replicasets", "default", "web", scale)
        assert wait_until_ctrl(lambda: len(server.list("pods")[0]) == 1)
    finally:
        rs_ctrl.stop()
        sched.stop()
        hollow.stop()


def test_gc_cascades_replicaset_pods():
    server = APIServer()
    rs_ctrl = ReplicaSetController(server)
    gc = GarbageCollector(server, period=0.2)
    rs_ctrl.start()
    gc.start()
    try:
        server.create("replicasets", make_rs("api", replicas=2))
        assert wait_until_ctrl(lambda: len(server.list("pods")[0]) == 2)
        rs_ctrl.stop()  # so it doesn't recreate while we delete
        server.delete("replicasets", "default", "api")
        assert wait_until_ctrl(lambda: len(server.list("pods")[0]) == 0)
    finally:
        rs_ctrl.stop()
        gc.stop()


def test_nodelifecycle_detects_death_and_evicts():
    server = APIServer()
    hollow = HollowCluster(server, num_nodes=2, heartbeat_interval=0.2)
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    nlc = NodeLifecycleController(
        server,
        node_monitor_period=0.2,
        node_monitor_grace_period=1.0,
        pod_eviction_timeout=1.5,
    )
    hollow.start()
    sched.start()
    nlc.start()
    try:
        from tests_util_pods import simple_pod
    except ImportError:
        from kubernetes_tpu_torch.api.objects import Pod

        def simple_pod(name):
            return Pod(
                metadata=ObjectMeta(name=name),
                spec=PodSpec(containers=[Container(requests={"cpu": "100m"})]),
            )

    try:
        server.create("pods", simple_pod("victim"))
        assert wait_until_ctrl(
            lambda: server.get("pods", "default", "victim").spec.node_name
        )
        node_name = server.get("pods", "default", "victim").spec.node_name
        hollow.kill_node(node_name)  # stops its lease renewals
        assert wait_until_ctrl(
            lambda: any(
                t.key == TAINT_UNREACHABLE
                for t in server.get("nodes", "", node_name).spec.taints
            ),
            timeout=15,
        )
        # pod evicted after timeout
        assert wait_until_ctrl(
            lambda: not any(
                p.metadata.name == "victim" for p in server.list("pods")[0]
            ),
            timeout=15,
        )
        # the OTHER node recovers never-died state: still untainted
        other = next(
            n.metadata.name
            for n in server.list("nodes")[0]
            if n.metadata.name != node_name
        )
        assert not server.get("nodes", "", other).spec.taints
    finally:
        nlc.stop()
        sched.stop()
        hollow.stop()


def test_namespace_controller_drains():
    server = APIServer()
    nsc = NamespaceController(server, period=0.2)
    nsc.start()
    try:
        server.create(
            "namespaces", Namespace(metadata=ObjectMeta(name="scratch", namespace=""))
        )
        from kubernetes_tpu_torch.api.objects import Pod

        server.create(
            "pods",
            Pod(
                metadata=ObjectMeta(name="p", namespace="scratch"),
                spec=PodSpec(containers=[Container(requests={"cpu": "1"})]),
            ),
        )

        def term(ns):
            ns.phase = "Terminating"
            return ns

        server.guaranteed_update("namespaces", "", "scratch", term)
        assert wait_until_ctrl(
            lambda: not server.list("pods", namespace="scratch")[0]
        )
        assert wait_until_ctrl(
            lambda: not any(
                n.metadata.name == "scratch"
                for n in server.list("namespaces")[0]
            )
        )
    finally:
        nsc.stop()


def test_controller_manager_runs_all():
    server = APIServer()
    mgr = ControllerManager(server)
    mgr.start()
    try:
        assert mgr._started.wait(5)
        assert set(mgr.controllers) == {
            "replicaset",
            "deployment",
            "job",
            "daemonset",
            "statefulset",
            "endpoints",
            "disruption",
            "nodelifecycle",
            "garbagecollector",
            "namespace",
            "horizontalpodautoscaling",
            "cronjob",
            "resourcequota",
            "serviceaccount",
            "ttl",
            "ttlafterfinished",
            "endpointslice",
            "nodeipam",
            "attachdetach",
            "persistentvolume-binder",
            "podgc",
            "pvc-protection",
            "pv-protection",
            "root-ca-cert-publisher",
            "replicationcontroller",
            "csrsigning",
            "csrapproving",
            "csrcleaner",
            "tokencleaner",
            "bootstrapsigner",
            "persistentvolume-expander",
            "clusterrole-aggregation",
        }
    finally:
        mgr.stop()


def test_hollow_cluster_scale_smoke():
    """Kubemark-style scale smoke (SURVEY §4: hollow nodes let a big
    control plane run on one box): 200 hollow kubelets, 1000 pods,
    everything Running with status/IP posted by the shared kubelet path."""
    server = APIServer()
    hollow = HollowCluster(
        server,
        num_nodes=200,
        heartbeat_interval=2.0,
        housekeeping_interval=0.5,
    )
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    hollow.start()
    sched.start()
    try:
        from kubernetes_tpu_torch.api.objects import Pod

        for i in range(1000):
            server.create(
                "pods",
                Pod(
                    metadata=ObjectMeta(name=f"scale-{i}"),
                    spec=PodSpec(
                        containers=[Container(requests={"cpu": "10m"})]
                    ),
                ),
            )
        deadline = time.time() + 120
        running = 0
        while time.time() < deadline:
            running = server.count(
                "pods", lambda p: p.status.phase == "Running"
            )
            if running >= 1000:
                break
            time.sleep(0.25)
        assert running >= 1000, f"only {running}/1000 pods Running"
        # spread across the fleet, and every Running pod has a sandbox IP.
        # Near-perfect, not exact: batch composition shifts under CPU
        # contention and a 1024-pod wave can legitimately land 6-on-a-node
        # leaving a couple of nodes empty (observed 197/200 under load,
        # 200/200 idle) — the smoke gate is breadth, not perfect balance
        nodes_used = {
            p.spec.node_name for p in server.list("pods")[0] if p.spec.node_name
        }
        assert len(nodes_used) >= 195, f"only {len(nodes_used)}/200 nodes used"
        assert all(
            p.status.pod_ip
            for p in server.list("pods")[0]
            if p.status.phase == "Running"
        )
    finally:
        sched.stop()
        hollow.stop()


# -- tests/test_bootstrap_rbac_expand.py -------------------------------
# The five controllers completing the reference's 35-loop set
# (cmd/kube-controller-manager/app/controllermanager.go:372-414):
# bootstrapsigner, csrapproving/csrcleaner (approver split from signer),
# persistentvolume-expander, clusterrole-aggregation — plus the RBAC object
# model (ClusterRole/ClusterRoleBinding) feeding the authorizer.
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer


def wait_until_rbac(cond, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def make_token_secret(name, tid, tsec, signing=True):
    data = {
        "token-id": tid.encode(),
        "token-secret": tsec.encode(),
    }
    if signing:
        data["usage-bootstrap-signing"] = b"true"
    return v1.Secret(
        metadata=v1.ObjectMeta(name=name, namespace="kube-system"),
        type="bootstrap.kubernetes.io/token",
        data=data,
    )


def test_bootstrap_signer_signs_and_prunes():
    from kubernetes_tpu_torch.controller.bootstrap import (
        JWS_PREFIX,
        BootstrapSignerController,
        compute_detached_signature,
    )

    server = APIServer()
    server.create(
        "configmaps",
        v1.ConfigMap(
            metadata=v1.ObjectMeta(name="cluster-info", namespace="kube-public"),
            data={"kubeconfig": '{"server": "http://127.0.0.1:1"}'},
        ),
    )
    server.create("secrets", make_token_secret("bootstrap-token-abc", "abc123", "s3cret"))
    ctrl = BootstrapSignerController(server)
    ctrl.start()
    try:
        def has_sig():
            cm = server.get("configmaps", "kube-public", "cluster-info")
            return JWS_PREFIX + "abc123" in cm.data

        assert wait_until_rbac(has_sig), "signature must appear for the signing token"
        cm = server.get("configmaps", "kube-public", "cluster-info")
        assert cm.data[JWS_PREFIX + "abc123"] == compute_detached_signature(
            cm.data["kubeconfig"], "abc123", "s3cret"
        )

        # a non-signing token gets no signature
        server.create(
            "secrets", make_token_secret("bootstrap-token-x", "nosign", "x", signing=False)
        )
        # deleting the signing token prunes its signature
        server.delete("secrets", "kube-system", "bootstrap-token-abc")
        assert wait_until_rbac(
            lambda: JWS_PREFIX + "abc123"
            not in server.get("configmaps", "kube-public", "cluster-info").data
        ), "signature must be pruned when its token goes away"
        assert (
            JWS_PREFIX + "nosign"
            not in server.get("configmaps", "kube-public", "cluster-info").data
        )
    finally:
        ctrl.stop()


def test_csr_cleaner_reaps_stale_requests():
    from kubernetes_tpu_torch.controller.certificates import (
        APPROVED,
        DENIED,
        CSRCleanerController,
    )

    server = APIServer()
    old = time.time() - 3600

    def csr(name, conds=(), cert=""):
        c = v1.CertificateSigningRequest(
            metadata=v1.ObjectMeta(name=name, namespace=""),
            status=v1.CertificateSigningRequestStatus(
                conditions=[
                    v1.PodCondition(type=t, status="True") for t in conds
                ],
                certificate=cert,
            ),
        )
        c.metadata.creation_timestamp = old
        return c

    server.create("certificatesigningrequests", csr("signed", (APPROVED,), "certdata"))
    server.create("certificatesigningrequests", csr("denied", (DENIED,)))
    server.create("certificatesigningrequests", csr("pending"))
    server.create("certificatesigningrequests", csr("inflight", (APPROVED,)))  # approved, unsigned
    fresh = v1.CertificateSigningRequest(metadata=v1.ObjectMeta(name="fresh", namespace=""))
    server.create("certificatesigningrequests", fresh)

    ctrl = CSRCleanerController(
        server, tick=0.1, signed_ttl=1.0, denied_ttl=1.0, pending_ttl=7200.0
    )
    ctrl.start()
    try:
        assert wait_until_rbac(
            lambda: {
                c.metadata.name
                for c in server.list("certificatesigningrequests")[0]
            }
            == {"pending", "inflight", "fresh"}
        ), "signed + denied past TTL reaped; pending/in-flight/fresh kept"
    finally:
        ctrl.stop()


def test_volume_expand_controller():
    from kubernetes_tpu_torch.controller.pv_binder import PVBinderController
    from kubernetes_tpu_torch.controller.volume_expand import VolumeExpandController

    server = APIServer()
    server.create(
        "storageclasses",
        v1.StorageClass(
            metadata=v1.ObjectMeta(name="fast", namespace=""),
            provisioner="tpu.csi",
            allow_volume_expansion=True,
        ),
    )
    server.create(
        "storageclasses",
        v1.StorageClass(
            metadata=v1.ObjectMeta(name="fixed", namespace=""),
            provisioner="tpu.csi",
        ),
    )
    for sc in ("fast", "fixed"):
        server.create(
            "persistentvolumes",
            v1.PersistentVolume(
                metadata=v1.ObjectMeta(name=f"pv-{sc}", namespace=""),
                spec=v1.PersistentVolumeSpec(
                    capacity={"storage": "10Gi"}, storage_class_name=sc
                ),
            ),
        )
        server.create(
            "persistentvolumeclaims",
            v1.PersistentVolumeClaim(
                metadata=v1.ObjectMeta(name=f"claim-{sc}"),
                spec=v1.PersistentVolumeClaimSpec(
                    resources={"storage": "10Gi"}, storage_class_name=sc
                ),
            ),
        )
    binder = PVBinderController(server)
    expander = VolumeExpandController(server)
    binder.start()
    expander.start()
    try:
        assert wait_until_rbac(
            lambda: all(
                server.get("persistentvolumeclaims", "default", f"claim-{sc}").status.phase
                == v1.CLAIM_BOUND
                for sc in ("fast", "fixed")
            )
        )
        # bind copies provisioned capacity into claim status
        assert (
            server.get("persistentvolumeclaims", "default", "claim-fast")
            .status.capacity["storage"]
            == "10Gi"
        )
        for sc in ("fast", "fixed"):
            server.guaranteed_update(
                "persistentvolumeclaims", "default", f"claim-{sc}",
                lambda c: (c.spec.resources.__setitem__("storage", "20Gi"), c)[1],
            )
        assert wait_until_rbac(
            lambda: server.get("persistentvolumeclaims", "default", "claim-fast")
            .status.capacity.get("storage")
            == "20Gi"
        ), "expandable class must grow"
        assert (
            server.get("persistentvolumes", "", "pv-fast").spec.capacity["storage"]
            == "20Gi"
        )
        time.sleep(0.3)
        assert (
            server.get("persistentvolumeclaims", "default", "claim-fixed")
            .status.capacity.get("storage")
            == "10Gi"
        ), "class without allowVolumeExpansion must not grow"
    finally:
        binder.stop()
        expander.stop()


def test_clusterrole_aggregation():
    from kubernetes_tpu_torch.api.selectors import LabelSelector
    from kubernetes_tpu_torch.controller.rbac import ClusterRoleAggregationController

    server = APIServer()
    server.create(
        "clusterroles",
        v1.ClusterRole(
            metadata=v1.ObjectMeta(name="view", namespace=""),
            aggregation_rule=v1.AggregationRule(
                cluster_role_selectors=[
                    LabelSelector.make({"rbac.tpu/aggregate-to-view": "true"})
                ]
            ),
        ),
    )
    ctrl = ClusterRoleAggregationController(server)
    ctrl.start()
    try:
        server.create(
            "clusterroles",
            v1.ClusterRole(
                metadata=v1.ObjectMeta(
                    name="view-pods",
                    namespace="",
                    labels={"rbac.tpu/aggregate-to-view": "true"},
                ),
                rules=[v1.PolicyRule(verbs=["get", "list"], resources=["pods"])],
            ),
        )
        assert wait_until_rbac(
            lambda: any(
                "pods" in r.resources
                for r in server.get("clusterroles", "", "view").rules
            )
        ), "matching role's rules must aggregate in"

        server.create(
            "clusterroles",
            v1.ClusterRole(
                metadata=v1.ObjectMeta(
                    name="view-cms",
                    namespace="",
                    labels={"rbac.tpu/aggregate-to-view": "true"},
                ),
                rules=[v1.PolicyRule(verbs=["get"], resources=["configmaps"])],
            ),
        )
        assert wait_until_rbac(
            lambda: {
                res
                for r in server.get("clusterroles", "", "view").rules
                for res in r.resources
            }
            == {"pods", "configmaps"}
        )
        server.delete("clusterroles", "", "view-pods")
        assert wait_until_rbac(
            lambda: {
                res
                for r in server.get("clusterroles", "", "view").rules
                for res in r.resources
            }
            == {"configmaps"}
        ), "removing a source role must shrink the aggregate"

        # chained aggregation (admin <- view): view is itself labeled into
        # admin's selector; a change flowing into view must propagate on
        # to admin even though view is an aggregating role
        server.create(
            "clusterroles",
            v1.ClusterRole(
                metadata=v1.ObjectMeta(name="admin", namespace=""),
                aggregation_rule=v1.AggregationRule(
                    cluster_role_selectors=[
                        LabelSelector.make({"rbac.tpu/aggregate-to-admin": "true"})
                    ]
                ),
            ),
        )
        server.guaranteed_update(
            "clusterroles", "", "view",
            lambda r: (
                r.metadata.labels.__setitem__(
                    "rbac.tpu/aggregate-to-admin", "true"
                ),
                r,
            )[1],
        )
        server.create(
            "clusterroles",
            v1.ClusterRole(
                metadata=v1.ObjectMeta(
                    name="view-nodes",
                    namespace="",
                    labels={"rbac.tpu/aggregate-to-view": "true"},
                ),
                rules=[v1.PolicyRule(verbs=["get"], resources=["nodes"])],
            ),
        )
        assert wait_until_rbac(
            lambda: {
                res
                for r in server.get("clusterroles", "", "admin").rules
                for res in r.resources
            }
            >= {"configmaps", "nodes"}
        ), "rules must flow through the chain view -> admin"
    finally:
        ctrl.stop()


def test_rbac_objects_drive_authorizer():
    from kubernetes_tpu_torch.apiserver.auth import RBACAuthorizer, UserInfo

    server = APIServer()
    server.create(
        "clusterroles",
        v1.ClusterRole(
            metadata=v1.ObjectMeta(name="pod-reader", namespace=""),
            rules=[v1.PolicyRule(verbs=["get", "list"], resources=["pods"])],
        ),
    )
    server.create(
        "clusterrolebindings",
        v1.ClusterRoleBinding(
            metadata=v1.ObjectMeta(name="alice-reads", namespace=""),
            role_ref=v1.RoleRef(name="pod-reader"),
            subjects=[
                v1.Subject(kind="User", name="alice"),
                v1.Subject(kind="Group", name="auditors"),
                v1.Subject(kind="ServiceAccount", name="sa1", namespace="ns1"),
            ],
        ),
    )
    authz = RBACAuthorizer(server=server)
    alice = UserInfo("alice", ())
    bob = UserInfo("bob", ())
    auditor = UserInfo("carol", ("auditors",))
    sa = UserInfo("system:serviceaccount:ns1:sa1", ("system:serviceaccounts",))
    assert authz.authorize(alice, "get", "pods", "default")
    assert authz.authorize(auditor, "list", "pods", "default")
    assert authz.authorize(sa, "get", "pods", "default")
    assert not authz.authorize(bob, "get", "pods", "default")
    assert not authz.authorize(alice, "delete", "pods", "default")
    assert not authz.authorize(alice, "get", "secrets", "default")

    # resourceNames scoping: the grant covers only the named object, and a
    # name-restricted rule never matches unnamed requests (list)
    server.create(
        "clusterroles",
        v1.ClusterRole(
            metadata=v1.ObjectMeta(name="one-secret", namespace=""),
            rules=[
                v1.PolicyRule(
                    verbs=["get"],
                    resources=["secrets"],
                    resource_names=["the-cert"],
                )
            ],
        ),
    )
    server.create(
        "clusterrolebindings",
        v1.ClusterRoleBinding(
            metadata=v1.ObjectMeta(name="bob-one-secret", namespace=""),
            role_ref=v1.RoleRef(name="one-secret"),
            subjects=[v1.Subject(kind="User", name="bob")],
        ),
    )
    authz._obj_built_at = float("-inf")  # bust the TTL cache
    assert authz.authorize(bob, "get", "secrets", "default", name="the-cert")
    assert not authz.authorize(bob, "get", "secrets", "default", name="other")
    assert not authz.authorize(bob, "get", "secrets", "default")
    assert not authz.authorize(bob, "list", "secrets", "default")


# -- tests/test_cloud_controllers.py -----------------------------------
# cloud-controller-manager loops against the fake cloud provider
# (reference cmd/cloud-controller-manager + pkg/controller/{cloud,route} +
# cloud-provider/fake).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.cloud import (
    FakeCloudProvider,
    RouteController,
    ServiceLBController,
)
from kubernetes_tpu_torch.controller.nodeipam import NodeIpamController


def wait_until_cloud(fn, timeout=25.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def test_loadbalancer_services_get_external_ips():
    server = APIServer()
    cloud = FakeCloudProvider()
    ctrl = ServiceLBController(server, cloud=cloud)
    server.create(
        "services",
        v1.Service(
            metadata=v1.ObjectMeta(name="lb"),
            spec=v1.ServiceSpec(type="LoadBalancer", ports=[("http", 80)]),
        ),
    )
    server.create(
        "services",
        v1.Service(
            metadata=v1.ObjectMeta(name="plain"),
            spec=v1.ServiceSpec(ports=[("http", 80)]),
        ),
    )
    ctrl.start()
    try:
        assert wait_until_cloud(
            lambda: server.get("services", "default", "lb").spec.external_ips
        ), "LoadBalancer service must get an external IP"
        ip = server.get("services", "default", "lb").spec.external_ips[0]
        assert ip.startswith("203.0.113.")
        assert cloud.load_balancers == {"default/lb": ip}
        # ClusterIP services never touch the cloud
        assert not server.get("services", "default", "plain").spec.external_ips
        # deleting the service tears down the LB
        server.delete("services", "default", "lb")
        assert wait_until_cloud(lambda: not cloud.load_balancers)
    finally:
        ctrl.stop()


def test_routes_follow_node_pod_cidrs():
    server = APIServer()
    cloud = FakeCloudProvider()
    ipam = NodeIpamController(server)
    routes = RouteController(server, cloud=cloud)
    for i in range(3):
        server.create(
            "nodes",
            v1.Node(metadata=v1.ObjectMeta(name=f"n{i}"), spec=v1.NodeSpec()),
        )
    ipam.start()
    routes.start()
    try:
        def routed():
            r = cloud.list_routes()
            return len(r) == 3 and all(c.startswith("10.244.") for c in r.values())

        assert wait_until_cloud(routed), "every node CIDR needs a cloud route"
        server.delete("nodes", "default", "n0")
        assert wait_until_cloud(lambda: "n0" not in cloud.list_routes())
    finally:
        routes.stop()
        ipam.stop()


def test_cloud_node_controller_initializes_nodes():
    """A node registering with the cloudprovider uninitialized taint gets
    providerID, instance-type/zone labels, addresses, and the taint
    cleared once the instance is known
    (pkg/controller/cloud/node_controller.go)."""
    from kubernetes_tpu_torch.controller.cloud import (
        TAINT_UNINITIALIZED,
        CloudInstance,
        CloudNodeController,
    )

    server = APIServer()
    cloud = FakeCloudProvider()
    cloud.add_instance(
        "n0",
        CloudInstance(
            provider_id="fake://n0",
            instance_type="tpu-v5e-8",
            zone="zone-b",
            addresses=(("InternalIP", "10.0.0.5"),),
        ),
    )
    ctrl = CloudNodeController(server, cloud=cloud)
    server.create(
        "nodes",
        v1.Node(
            metadata=v1.ObjectMeta(name="n0", namespace=""),
            spec=v1.NodeSpec(
                taints=[
                    v1.Taint(
                        key=TAINT_UNINITIALIZED,
                        effect=v1.TAINT_NO_SCHEDULE,
                    )
                ]
            ),
        ),
    )
    ctrl.start()
    try:
        assert wait_until_cloud(
            lambda: not any(
                t.key == TAINT_UNINITIALIZED
                for t in server.get("nodes", "", "n0").spec.taints
            )
        )
        n = server.get("nodes", "", "n0")
        assert n.spec.provider_id == "fake://n0"
        assert n.metadata.labels["node.kubernetes.io/instance-type"] == "tpu-v5e-8"
        assert n.metadata.labels["topology.kubernetes.io/zone"] == "zone-b"
        assert ("InternalIP", "10.0.0.5") in [
            tuple(a) for a in n.status.addresses
        ]
    finally:
        ctrl.stop()


def test_cloud_node_lifecycle_deletes_gone_and_taints_shutdown():
    """(pkg/controller/cloud/node_lifecycle_controller.go): instance gone
    -> Node deleted; instance shutdown -> shutdown taint; instance back
    -> taint removed. Uncloud-managed nodes are never touched."""
    from kubernetes_tpu_torch.client.apiserver import NotFound
    from kubernetes_tpu_torch.controller.cloud import (
        TAINT_SHUTDOWN,
        CloudNodeLifecycleController,
    )

    server = APIServer()
    cloud = FakeCloudProvider()
    for name in ("gone", "asleep", "healthy"):
        cloud.add_instance(name)
        server.create(
            "nodes", v1.Node(metadata=v1.ObjectMeta(name=name, namespace=""))
        )
    # a node the cloud never knew (on-prem): must never be deleted
    server.create(
        "nodes", v1.Node(metadata=v1.ObjectMeta(name="onprem", namespace=""))
    )
    lc = CloudNodeLifecycleController(server, cloud=cloud, period_s=999)

    cloud.instances["gone"].exists = False
    cloud.instances["asleep"].shutdown = True
    lc.sweep()

    try:
        server.get("nodes", "", "gone")
        assert False, "gone node should be deleted"
    except NotFound:
        pass
    asleep = server.get("nodes", "", "asleep")
    assert any(t.key == TAINT_SHUTDOWN for t in asleep.spec.taints)
    assert server.get("nodes", "", "healthy").spec.taints == []
    assert server.get("nodes", "", "onprem") is not None

    # instance wakes: the taint clears on the next sweep
    cloud.instances["asleep"].shutdown = False
    lc.sweep()
    asleep = server.get("nodes", "", "asleep")
    assert not any(t.key == TAINT_SHUTDOWN for t in asleep.spec.taints)


def test_lb_status_and_hosts_follow_nodes():
    """status.loadBalancer.ingress is written alongside external_ips, and
    the LB's backend host set tracks Ready schedulable nodes."""
    server = APIServer()
    cloud = FakeCloudProvider()
    for name, ready in (("n0", True), ("n1", True), ("n2", False)):
        server.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=name, namespace=""),
                status=v1.NodeStatus(
                    conditions=[
                        v1.NodeCondition(
                            type=v1.NODE_READY,
                            status="True" if ready else "False",
                        )
                    ]
                ),
            ),
        )
    ctrl = ServiceLBController(server, cloud=cloud)
    server.create(
        "services",
        v1.Service(
            metadata=v1.ObjectMeta(name="lb2"),
            spec=v1.ServiceSpec(type="LoadBalancer", ports=[("http", 80)]),
        ),
    )
    ctrl.start()
    try:
        assert wait_until_cloud(
            lambda: server.get("services", "default", "lb2")
            .status.load_balancer.ingress
        )
        assert cloud.lb_hosts["default/lb2"] == ("n0", "n1")
        # a node drains: the host-sync hook updates every LB
        server.guaranteed_update(
            "nodes", "", "n1",
            lambda n: (setattr(n.spec, "unschedulable", True), n)[1],
        )
        ctrl.sync_hosts()
        assert cloud.lb_hosts["default/lb2"] == ("n0",)
    finally:
        ctrl.stop()


def test_node_events_refresh_lb_hosts():
    """A node draining triggers the host-set refresh through the
    controller's own node watch (no manual sync_hosts call)."""
    server = APIServer()
    cloud = FakeCloudProvider()
    for name in ("na", "nb"):
        server.create(
            "nodes",
            v1.Node(
                metadata=v1.ObjectMeta(name=name, namespace=""),
                status=v1.NodeStatus(
                    conditions=[
                        v1.NodeCondition(type=v1.NODE_READY, status="True")
                    ]
                ),
            ),
        )
    ctrl = ServiceLBController(server, cloud=cloud)
    server.create(
        "services",
        v1.Service(
            metadata=v1.ObjectMeta(name="lb3"),
            spec=v1.ServiceSpec(type="LoadBalancer", ports=[("http", 80)]),
        ),
    )
    ctrl.start()
    try:
        assert wait_until_cloud(lambda: cloud.lb_hosts.get("default/lb3") == ("na", "nb"))
        server.guaranteed_update(
            "nodes", "", "nb",
            lambda n: (setattr(n.spec, "unschedulable", True), n)[1],
        )
        assert wait_until_cloud(lambda: cloud.lb_hosts.get("default/lb3") == ("na",))
    finally:
        ctrl.stop()


# -- tests/test_storage_network_controllers.py -------------------------
# EndpointSlice, NodeIPAM, attach-detach, PV binder controllers
# (reference: pkg/controller/{endpointslice,nodeipam,volume/attachdetach,
# volume/persistentvolume}).
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.attachdetach import AttachDetachController
from kubernetes_tpu_torch.controller.endpointslice import (
    SERVICE_NAME_LABEL,
    EndpointSliceController,
)
from kubernetes_tpu_torch.controller.nodeipam import NodeIpamController
from kubernetes_tpu_torch.controller.pv_binder import PVBinderController


def wait_until_storage(fn, timeout=25.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def _running_pod(name, labels, ip, node="n0"):
    p = v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": "100m"})], node_name=node
        ),
    )
    p.status.phase = v1.POD_RUNNING
    p.status.pod_ip = ip
    return p


def test_endpointslice_slicing_and_cleanup():
    server = APIServer()
    server.create(
        "services",
        v1.Service(
            metadata=v1.ObjectMeta(name="web"),
            spec=v1.ServiceSpec(selector={"app": "web"}, ports=[("http", 80)]),
        ),
    )
    for i in range(5):
        server.create(
            "pods", _running_pod(f"w{i}", {"app": "web"}, f"10.0.0.{i+1}")
        )
    ctrl = EndpointSliceController(server, max_endpoints_per_slice=2)
    ctrl.start()
    try:
        def sliced():
            slices, _ = server.list("endpointslices")
            mine = [
                s
                for s in slices
                if s.metadata.labels.get(SERVICE_NAME_LABEL) == "web"
            ]
            total = sum(len(s.endpoints) for s in mine)
            return len(mine) == 3 and total == 5 and all(
                len(s.endpoints) <= 2 for s in mine
            )

        assert wait_until_storage(sliced), "5 endpoints must split into 3 slices of <=2"
        # shrink the pod set -> surplus slices deleted
        for i in range(4):
            server.delete("pods", "default", f"w{i}")
        def shrunk():
            slices, _ = server.list("endpointslices")
            mine = [
                s
                for s in slices
                if s.metadata.labels.get(SERVICE_NAME_LABEL) == "web"
            ]
            return len(mine) == 1 and len(mine[0].endpoints) == 1

        assert wait_until_storage(shrunk), "slices must shrink with the pod set"
    finally:
        ctrl.stop()


def test_nodeipam_allocates_unique_cidrs():
    server = APIServer()
    for i in range(5):
        server.create(
            "nodes", v1.Node(metadata=v1.ObjectMeta(name=f"n{i}"), spec=v1.NodeSpec())
        )
    ctrl = NodeIpamController(server, cluster_cidr="10.244.0.0/20", node_mask_size=24)
    ctrl.start()
    try:
        def all_allocated():
            nodes, _ = server.list("nodes")
            cidrs = [n.spec.pod_cidr for n in nodes]
            return all(cidrs) and len(set(cidrs)) == 5

        assert wait_until_storage(all_allocated), "every node needs a distinct pod CIDR"
        nodes, _ = server.list("nodes")
        assert all(n.spec.pod_cidr.startswith("10.244.") for n in nodes)
    finally:
        ctrl.stop()


def _pv(name, size="10Gi", sc=""):
    return v1.PersistentVolume(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        spec=v1.PersistentVolumeSpec(
            capacity={"storage": size},
            access_modes=["ReadWriteOnce"],
            storage_class_name=sc,
        ),
    )


def _pvc(name, size="5Gi", sc=None):
    return v1.PersistentVolumeClaim(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PersistentVolumeClaimSpec(
            access_modes=["ReadWriteOnce"],
            resources={"storage": size},
            storage_class_name=sc,
        ),
    )


def test_pv_binder_matches_smallest_fit():
    server = APIServer()
    server.create("persistentvolumes", _pv("big", "100Gi"))
    server.create("persistentvolumes", _pv("small", "10Gi"))
    server.create("persistentvolumeclaims", _pvc("claim", "5Gi"))
    ctrl = PVBinderController(server)
    ctrl.start()
    try:
        def bound():
            c = server.get("persistentvolumeclaims", "default", "claim")
            return c.spec.volume_name == "small" and c.status.phase == "Bound"

        assert wait_until_storage(bound), "binder must pick the smallest satisfying PV"
        pv = server.get("persistentvolumes", "", "small")
        assert pv.spec.claim_ref == "default/claim"
        assert pv.status.phase == "Bound"
        # deleting the claim releases the volume
        server.delete("persistentvolumeclaims", "default", "claim")
        assert wait_until_storage(
            lambda: server.get("persistentvolumes", "", "small").status.phase
            == "Released"
        )
    finally:
        ctrl.stop()


def test_pv_binder_dynamic_provisioning():
    server = APIServer()
    server.create(
        "storageclasses",
        v1.StorageClass(
            metadata=v1.ObjectMeta(name="fast", namespace=""),
            provisioner="csi.example.com",
        ),
    )
    server.create("persistentvolumeclaims", _pvc("dyn", "2Gi", sc="fast"))
    ctrl = PVBinderController(server)
    ctrl.start()
    try:
        def provisioned():
            c = server.get("persistentvolumeclaims", "default", "dyn")
            if not c.spec.volume_name:
                return False
            pv = server.get("persistentvolumes", "", c.spec.volume_name)
            return (
                pv.spec.csi is not None
                and pv.spec.csi.driver == "csi.example.com"
                and pv.spec.storage_class_name == "fast"
            )

        assert wait_until_storage(provisioned), "provisioner class must create + bind a PV"
    finally:
        ctrl.stop()


def test_attach_detach_follows_pod_placement():
    server = APIServer()
    pv = _pv("disk-1", "10Gi")
    pv.spec.claim_ref = "default/data"
    pv.status.phase = "Bound"
    server.create("persistentvolumes", pv)
    pvc = _pvc("data", "5Gi")
    pvc.spec.volume_name = "disk-1"
    pvc.status.phase = "Bound"
    server.create("persistentvolumeclaims", pvc)

    pod = v1.Pod(
        metadata=v1.ObjectMeta(name="db"),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": "100m"})],
            node_name="n3",
            volumes=[v1.Volume(name="data", persistent_volume_claim="data")],
        ),
    )
    server.create("pods", pod)
    ctrl = AttachDetachController(server)
    ctrl.start()
    try:
        def attached():
            vas, _ = server.list("volumeattachments")
            return any(
                a.spec.pv_name == "disk-1"
                and a.spec.node_name == "n3"
                and a.status.attached
                for a in vas
            )

        assert wait_until_storage(attached), "placed pod's PV must attach to its node"
        server.delete("pods", "default", "db")
        assert wait_until_storage(
            lambda: not server.list("volumeattachments")[0]
        ), "attachment must detach when no pod uses it"
    finally:
        ctrl.stop()


# -- tests/test_gc_protection.py ---------------------------------------
# Pod GC, PVC/PV protection finalizers, root-CA publisher, priority
# admission, and the store's graceful-deletion core.
#
# Reference: pkg/controller/podgc, pkg/controller/volume/{pvcprotection,
# pvprotection}, pkg/controller/certificates/rootcacertpublisher,
# plugin/pkg/admission/priority, and the registry's finalizer-aware
# deletion.
import time

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.apiserver.auth import (
    AdmissionChain,
    AdmissionDenied,
    PriorityAdmission,
)
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.podgc import (
    PVC_FINALIZER,
    PodGCController,
    PVCProtectionController,
    RootCACertPublisher,
)


def wait_until_gc(fn, timeout=25.0, period=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(period)
    return False


def make_pod_gc(name, phase=None, node=None):
    p = v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "10m"})]),
    )
    if phase:
        p.status.phase = phase
    if node:
        p.spec.node_name = node
    return p


def test_store_graceful_deletion_with_finalizers():
    server = APIServer()
    pod = make_pod_gc("fin")
    pod.metadata.finalizers.append("example.com/hold")
    server.create("pods", pod)
    server.delete("pods", "default", "fin")
    # still present, marked deleting
    cur = server.get("pods", "default", "fin")
    assert cur.metadata.deletion_timestamp is not None
    # stripping the last finalizer completes the deletion
    def strip(p):
        p.metadata.finalizers.clear()
        return p

    server.guaranteed_update("pods", "default", "fin", strip)
    try:
        server.get("pods", "default", "fin")
        raise AssertionError("object must be gone after finalizer strip")
    except KeyError:
        pass


def test_podgc_threshold_and_orphans():
    server = APIServer()
    server.create("nodes", v1.Node(metadata=v1.ObjectMeta(name="live"), spec=v1.NodeSpec()))
    # 5 finished pods with a threshold of 2 -> 3 oldest GC'd
    for i in range(5):
        p = make_pod_gc(f"done-{i}", phase=v1.POD_SUCCEEDED)
        p.metadata.creation_timestamp = 1000.0 + i
        server.create("pods", p)
    server.create("pods", make_pod_gc("ghost", node="gone-node"))
    ctrl = PodGCController(server, terminated_pod_threshold=2, tick=0.2)
    ctrl.start()
    try:
        def gcd():
            names = {p.metadata.name for p in server.list("pods")[0]}
            return names == {"done-3", "done-4"}

        assert wait_until_gc(gcd), "oldest finished + orphaned pods must be GC'd"
    finally:
        ctrl.stop()


def test_pvc_protection_defers_deletion_while_in_use():
    server = APIServer()
    pvc = v1.PersistentVolumeClaim(
        metadata=v1.ObjectMeta(name="data"),
        spec=v1.PersistentVolumeClaimSpec(resources={"storage": "1Gi"}),
    )
    server.create("persistentvolumeclaims", pvc)
    user = make_pod_gc("user")
    user.spec.volumes.append(v1.Volume(name="data", persistent_volume_claim="data"))
    server.create("pods", user)
    ctrl = PVCProtectionController(server)
    ctrl.start()
    try:
        assert wait_until_gc(
            lambda: PVC_FINALIZER
            in server.get("persistentvolumeclaims", "default", "data").metadata.finalizers
        )
        server.delete("persistentvolumeclaims", "default", "data")
        time.sleep(0.5)
        cur = server.get("persistentvolumeclaims", "default", "data")
        assert cur.metadata.deletion_timestamp is not None, "deletion deferred"
        # the using pod goes away -> protection releases -> claim removed
        server.delete("pods", "default", "user")
        def gone():
            try:
                server.get("persistentvolumeclaims", "default", "data")
                return False
            except KeyError:
                return True

        assert wait_until_gc(gone), "claim must be removed once unused"
    finally:
        ctrl.stop()


def test_root_ca_published_per_namespace():
    server = APIServer()
    server.create("namespaces", v1.Namespace(metadata=v1.ObjectMeta(name="apps")))
    ctrl = RootCACertPublisher(server)
    ctrl.start()
    try:
        def published():
            try:
                cm = server.get("configmaps", "apps", "kube-root-ca.crt")
            except KeyError:
                return False
            return "ca.crt" in cm.data

        assert wait_until_gc(published)
    finally:
        ctrl.stop()


def test_priority_admission_resolves_class():
    server = APIServer()
    server.create(
        "priorityclasses",
        v1.PriorityClass(metadata=v1.ObjectMeta(name="high"), value=1000),
    )
    server.create(
        "priorityclasses",
        v1.PriorityClass(
            metadata=v1.ObjectMeta(name="base"), value=7, global_default=True
        ),
    )
    server.admit_hooks.append(AdmissionChain(mutating=[PriorityAdmission(server)]))

    named = make_pod_gc("named")
    named.spec.priority_class_name = "high"
    server.create("pods", named)
    assert server.get("pods", "default", "named").spec.priority == 1000

    plain = make_pod_gc("plain")
    server.create("pods", plain)
    got = server.get("pods", "default", "plain")
    assert got.spec.priority == 7 and got.spec.priority_class_name == "base"

    bogus = make_pod_gc("bogus")
    bogus.spec.priority_class_name = "nope"
    try:
        server.create("pods", bogus)
        raise AssertionError("unknown priority class must be denied")
    except AdmissionDenied:
        pass


def test_eviction_api_respects_pdb_and_kubectl_drain(capsys):
    """POST pods/{name}/eviction honors PDBs (429 when exhausted);
    kubectl drain cordons + evicts, retrying blocked pods until the
    disruption controller frees budget."""
    from kubernetes_tpu_torch.apiserver.rest import serve
    from kubernetes_tpu_torch.client.apiserver import TooManyRequests
    from kubernetes_tpu_torch.cmd import kubectl

    server = APIServer()
    for n in ("n0", "n1"):
        server.create(
            "nodes", v1.Node(metadata=v1.ObjectMeta(name=n), spec=v1.NodeSpec())
        )
    for i in range(3):
        p = make_pod_gc(f"web-{i}", node="n0" if i < 2 else "n1")
        p.metadata.labels["app"] = "web"
        p.status.phase = v1.POD_RUNNING
        server.create("pods", p)
    pdb = v1.PodDisruptionBudget(
        metadata=v1.ObjectMeta(name="web-pdb"),
        spec=v1.PodDisruptionBudgetSpec(min_available=2, selector={"app": "web"}),
    )
    pdb.status.disruptions_allowed = 1  # 3 healthy, min 2
    server.create("poddisruptionbudgets", pdb)

    # direct store semantics: first eviction consumes the budget, second 429s
    server.evict_pod("default", "web-2")
    try:
        server.evict_pod("default", "web-1")
        raise AssertionError("second eviction must violate the PDB")
    except TooManyRequests:
        pass

    # over HTTP: 429 carries TooManyRequests
    srv, port, _ = serve(store=server)
    try:
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/namespaces/default/pods/web-1/eviction",
            data=_json.dumps({"kind": "Eviction"}).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req)
            raise AssertionError("expected 429")
        except urllib.error.HTTPError as e:
            assert e.code == 429

        # free the budget (as the disruption controller would) and drain n0
        def free(b):
            b.status.disruptions_allowed = 2
            return b

        server.guaranteed_update("poddisruptionbudgets", "default", "web-pdb", free)
        rc = kubectl.main(
            ["--server", f"http://127.0.0.1:{port}", "drain", "n0", "--timeout", "20"]
        )
        assert rc == 0, capsys.readouterr().err
        left = [p.metadata.name for p in server.list("pods")[0]]
        assert left == [], f"drained node pods must be evicted: {left}"
    finally:
        srv.shutdown()


def test_auth_can_i(capsys):
    from kubernetes_tpu_torch.apiserver.auth import (
        RBACAuthorizer,
        TokenAuthenticator,
        make_rule,
    )
    from kubernetes_tpu_torch.apiserver.rest import serve
    from kubernetes_tpu_torch.cmd import kubectl

    authn = TokenAuthenticator(allow_anonymous=False)
    authn.add_token("tok", "alice")
    authz = RBACAuthorizer()
    authz.bind("alice", make_rule(["get", "list"], ["pods"]))
    srv, port, _ = serve(authenticator=authn, authorizer=authz)
    try:
        import urllib.request

        def can(verb, resource):
            import json as _json

            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v1/selfsubjectaccessreviews",
                data=_json.dumps(
                    {"spec": {"resourceAttributes": {"verb": verb, "resource": resource}}}
                ).encode(),
                method="POST",
                headers={
                    "Content-Type": "application/json",
                    "Authorization": "Bearer tok",
                },
            )
            with urllib.request.urlopen(req) as resp:
                return _json.loads(resp.read())["status"]["allowed"]

        assert can("get", "pods") is True
        assert can("delete", "pods") is False
        assert can("get", "secrets") is False
    finally:
        srv.shutdown()


def test_replication_controller_and_csr_signing():
    """RC shares the replicaset reconcile core; CSR approve+sign flow
    (pkg/controller/replication + pkg/controller/certificates — approver
    and signer are separate loops, as in the reference)."""
    from kubernetes_tpu_torch.controller.certificates import (
        APPROVED,
        CSRApprovingController,
        CSRSigningController,
    )
    from kubernetes_tpu_torch.controller.replicaset import (
        ReplicationControllerController,
    )

    server = APIServer()
    rc = v1.ReplicationController(
        metadata=v1.ObjectMeta(name="legacy"),
        spec=v1.ReplicaSetSpec(
            replicas=3,
            selector={"app": "legacy"},
            template=v1.PodTemplateSpec(
                metadata=v1.ObjectMeta(labels={"app": "legacy"}),
                spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "10m"})]),
            ),
        ),
    )
    server.create("replicationcontrollers", rc)
    ctrl = ReplicationControllerController(server)
    ctrl.start()
    try:
        assert wait_until_gc(
            lambda: sum(
                1
                for p in server.list("pods")[0]
                if any(
                    r.kind == "ReplicationController" and r.controller
                    for r in p.metadata.owner_references
                )
            )
            == 3
        ), "RC must maintain 3 replicas"
    finally:
        ctrl.stop()

    csr = v1.CertificateSigningRequest(
        metadata=v1.ObjectMeta(name="node-csr", namespace=""),
        spec=v1.CertificateSigningRequestSpec(
            request="worker-0-pubkey",
            username="system:bootstrap",
            groups=["system:bootstrappers"],
        ),
    )
    server.create("certificatesigningrequests", csr)
    approver = CSRApprovingController(server)
    signer = CSRSigningController(server)
    approver.start()
    signer.start()
    try:
        def signed():
            cur = server.get("certificatesigningrequests", "", "node-csr")
            return (
                any(c.type == APPROVED and c.status == "True" for c in cur.status.conditions)
                and bool(cur.status.certificate)
            )

        assert wait_until_gc(signed), "bootstrap kubelet CSR must auto-approve + sign"
    finally:
        approver.stop()
        signer.stop()


# -- tests/test_preemption_pdb.py --------------------------------------
# Preemption with PDB budgets + the batched device what-if mask.
#
# Covers VERDICT r1 item 5: PDB counts are real (disruption controller
# publishes disruptionsAllowed; pickOneNodeForPreemption's first criterion),
# and the device what-if mask is validated against the host reprieve loop
# (optimistic: never excludes a node the host path could use).
import time

import pytest

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client import APIServer
from kubernetes_tpu_torch.controller.disruption import DisruptionController
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
from kubernetes_tpu_torch.scheduler.preemption import (
    filter_pods_with_pdb_violation,
    pick_one_node_for_preemption,
)


def make_node(name, cpu="4", labels=None):
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace="", labels=labels or {}),
        status=v1.NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": 110}
        ),
    )


def make_pod_pdb(name, cpu="100m", prio=0, labels=None):
    p = v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels or {}),
        spec=v1.PodSpec(
            containers=[v1.Container(requests={"cpu": cpu})], priority=prio
        ),
    )
    return p


def wait_until_pdb(fn, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.03)
    return False


def test_filter_pods_with_pdb_violation_budget_countdown():
    pdb = v1.PodDisruptionBudget(
        metadata=v1.ObjectMeta(name="b"),
        spec=v1.PodDisruptionBudgetSpec(min_available=1, selector={"app": "a"}),
        status=v1.PodDisruptionBudgetStatus(disruptions_allowed=1),
    )
    pods = [make_pod_pdb(f"p{i}", labels={"app": "a"}) for i in range(3)]
    other = make_pod_pdb("other", labels={"app": "b"})
    violating, ok = filter_pods_with_pdb_violation(pods + [other], [pdb])
    # budget 1: first matching pod consumes it, the rest violate
    assert [p.metadata.name for p in ok] == ["p0", "other"]
    assert [p.metadata.name for p in violating] == ["p1", "p2"]


def test_filter_pods_with_pdb_violation_overlapping_budgets():
    """A pod matching SEVERAL PDBs consumes budget from each in list
    order, and one exhausted budget among its matches is enough to mark
    it violating (the any() rule) — the reference's per-PDB countdown,
    previously untested for the overlap case."""
    pdb_a = v1.PodDisruptionBudget(
        metadata=v1.ObjectMeta(name="a"),
        spec=v1.PodDisruptionBudgetSpec(min_available=1, selector={"app": "a"}),
        status=v1.PodDisruptionBudgetStatus(disruptions_allowed=2),
    )
    pdb_tier = v1.PodDisruptionBudget(
        metadata=v1.ObjectMeta(name="tier"),
        spec=v1.PodDisruptionBudgetSpec(
            min_available=1, selector={"tier": "gold"}
        ),
        status=v1.PodDisruptionBudgetStatus(disruptions_allowed=1),
    )
    both = [
        make_pod_pdb(f"b{i}", labels={"app": "a", "tier": "gold"})
        for i in range(2)
    ]
    only_a = make_pod_pdb("only-a", labels={"app": "a"})
    # b0 consumes a budget unit from BOTH pdbs; b1 then violates `tier`
    # (exhausted) even though `app: a` still has budget; only-a passes on
    # a's remaining unit
    violating, ok = filter_pods_with_pdb_violation(
        both + [only_a], [pdb_a, pdb_tier]
    )
    assert [p.metadata.name for p in ok] == ["b0", "only-a"]
    assert [p.metadata.name for p in violating] == ["b1"]
    # list order decides WHO gets the budget: reversed candidates flip
    # the survivor — pinning the reference's order-dependent countdown
    violating_r, ok_r = filter_pods_with_pdb_violation(
        [both[1], both[0], only_a], [pdb_a, pdb_tier]
    )
    assert [p.metadata.name for p in ok_r] == ["b1", "only-a"]
    assert [p.metadata.name for p in violating_r] == ["b0"]


def test_active_queue_equal_priority_fifo_tie_break():
    """activeQ orders by priority DESC then admission FIFO: equal-priority
    pods must pop in arrival order (the -timestamp half of the default
    less function, previously untested)."""
    from kubernetes_tpu_torch.scheduler.queue.scheduling_queue import PriorityQueue

    q = PriorityQueue()
    for i in range(5):
        p = make_pod_pdb(f"fifo-{i}", prio=7)
        q.add(p)
        time.sleep(0.002)  # monotonic timestamps must strictly order
    late_high = make_pod_pdb("late-high", prio=50)
    q.add(late_high)
    order = [q.pop(timeout=1).pod.metadata.name for _ in range(6)]
    assert order[0] == "late-high"  # priority beats arrival
    assert order[1:] == [f"fifo-{i}" for i in range(5)]  # FIFO within tier
    q.close()


def test_pick_one_node_prefers_fewest_pdb_violations():
    victims = {
        "a": [make_pod_pdb("v1", prio=0)],
        "b": [make_pod_pdb("v2", prio=0)],
    }
    # b has no violations, a has one -> pick b despite identical victims
    assert (
        pick_one_node_for_preemption(victims, None, {"a": 1, "b": 0}) == "b"
    )


@pytest.mark.parametrize("use_device", [True, False])
def test_preemption_respects_pdb_node_choice(use_device):
    """Two full nodes each hold a preemptable victim; the victim on node A
    is PDB-protected (disruptionsAllowed=0). The preemptor must evict from
    node B."""
    server = APIServer()
    sched = Scheduler(server, KubeSchedulerConfiguration(use_device=use_device), device="cpu")
    disruption = DisruptionController(server)
    server.create("nodes", make_node("node-a", cpu="2"))
    server.create("nodes", make_node("node-b", cpu="2"))
    sched.start()
    disruption.start()
    try:
        server.create(
            "pods", make_pod_pdb("protected", cpu="1500m", labels={"app": "quorum"})
        )
        server.create(
            "pods", make_pod_pdb("expendable", cpu="1500m", labels={"app": "batch"})
        )
        assert wait_until_pdb(
            lambda: all(
                p.spec.node_name for p in server.list("pods")[0]
            )
        )
        # mark both Running so the disruption controller counts them healthy
        for p in server.list("pods")[0]:
            def run(cur):
                cur.status.phase = v1.POD_RUNNING
                return cur

            server.guaranteed_update(
                "pods", p.metadata.namespace, p.metadata.name, run
            )
        server.create(
            "poddisruptionbudgets",
            v1.PodDisruptionBudget(
                metadata=v1.ObjectMeta(name="quorum-pdb"),
                spec=v1.PodDisruptionBudgetSpec(
                    min_available=1, selector={"app": "quorum"}
                ),
            ),
        )
        assert wait_until_pdb(
            lambda: server.get(
                "poddisruptionbudgets", "default", "quorum-pdb"
            ).status.observed_generation
            >= 0
            and server.get(
                "poddisruptionbudgets", "default", "quorum-pdb"
            ).status.current_healthy
            == 1
        )
        # high-priority pod needs a full node; only eviction helps
        server.create("pods", make_pod_pdb("urgent", cpu="1500m", prio=1000))
        assert wait_until_pdb(
            lambda: (server.get("pods", "default", "urgent").spec.node_name != "")
        ), [
            (p.metadata.name, p.spec.node_name)
            for p in server.list("pods")[0]
        ]
        names = {p.metadata.name for p in server.list("pods")[0]}
        assert "protected" in names, "PDB-protected pod was evicted"
        assert "expendable" not in names, "wrong victim chosen"
    finally:
        disruption.stop()
        sched.stop()


def test_preemption_policy_never_blocks_preemption():
    """A PriorityClass with preemptionPolicy=Never yields high priority
    WITHOUT the right to evict (admission.go + podEligibleToPreemptOthers):
    the pod queues ahead but never takes victims."""
    from kubernetes_tpu_torch.apiserver.auth import AdmissionChain, PriorityAdmission

    server = APIServer()
    server.create(
        "priorityclasses",
        v1.PriorityClass(
            metadata=v1.ObjectMeta(name="polite-high", namespace=""),
            value=100000,
            preemption_policy="Never",
        ),
    )
    server.admit_hooks.append(
        AdmissionChain(mutating=[PriorityAdmission(server)])
    )
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    server.create("nodes", make_node("only", cpu="2"))
    sched.start()
    try:
        low = make_pod_pdb("low", cpu="1500m")
        low.spec.priority = 0
        server.create("pods", low)
        deadline = time.time() + 30
        while time.time() < deadline:
            if server.get("pods", "default", "low").spec.node_name:
                break
            time.sleep(0.03)
        assert server.get("pods", "default", "low").spec.node_name == "only"

        polite = make_pod_pdb("polite", cpu="1500m")
        polite.spec.priority_class_name = "polite-high"
        server.create("pods", polite)
        stored = server.get("pods", "default", "polite")
        assert stored.spec.priority == 100000
        assert stored.spec.preemption_policy == "Never"
        time.sleep(2.0)
        # the victim survives and the polite pod stays pending
        names = {p.metadata.name for p in server.list("pods")[0]}
        assert "low" in names, "Never-policy pod must not evict"
        assert server.get("pods", "default", "polite").spec.node_name == ""
    finally:
        sched.stop()
