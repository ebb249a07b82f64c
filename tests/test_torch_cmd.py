"""The port's scheduler process entry (kubernetes_tpu_torch/cmd/scheduler.py)
and cache debugger on the CPU (device="cpu"), held to the reference tests'
own assertions:

* tests/test_config_and_cmd.py::test_cache_debugger_compare_and_dump and
  ::test_cmd_run_serves_healthz_and_metrics;
* tests/test_chaos_ha.py::test_cmd_run_with_election_standby_promotes_and_binds
  (the port's APIServer as a ChaosStore bind ledger, tests/
  test_torch_autoscaler.py, and the copied NodeAgentPool);

and, for the port: ``run`` with ``tune_policy=True`` starts the policy gym
beside the wave path (the recorder attached, gym passes made, the dump's
policy-gym section), and ``main`` maps ``--platform cpu`` to
``device="cpu"`` and anything else to the card.
"""

import json
import socket
import time
import urllib.request

from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.client.apiserver import APIServer
from kubernetes_tpu_torch.client.leaderelection import LeaderElectionConfig
from kubernetes_tpu_torch.cmd import scheduler as cmd_scheduler
from kubernetes_tpu_torch.kubelet.kubelet import NodeAgentPool
from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler
from kubernetes_tpu_torch.scheduler.cache.debugger import CacheDebugger
from kubernetes_tpu_torch.tuner.policy import COUNTER_GYM_PASSES
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_autoscaler import ChaosStore, assert_bind_invariants, wait_until


def make_node(name):
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        status=v1.NodeStatus(allocatable={"cpu": "4", "memory": "32Gi", "pods": 110}),
    )


def make_pod(name):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name),
        spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "100m"})]),
    )


def _bound_count(server):
    return server.count("pods", lambda p: bool(p.spec.node_name))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cache_debugger_compare_and_dump():
    server = APIServer()
    sched = Scheduler(server, KubeSchedulerConfiguration(), device="cpu")
    server.create("nodes", make_node("n0"))
    sched.start()
    try:
        server.create("pods", make_pod("p"))
        deadline = time.time() + 15
        while time.time() < deadline:
            if server.get("pods", "default", "p").spec.node_name:
                break
            time.sleep(0.02)
        time.sleep(0.3)  # let informer deliver the bound pod back to cache
        dbg = CacheDebugger(sched)
        nodes, pods = dbg.compare()
        assert nodes == [] and pods == []
        out = dbg.dump()
        assert "node n0: 1 pods" in out
    finally:
        sched.stop()


def test_cmd_run_serves_healthz_and_metrics():
    server = APIServer()
    server.create("nodes", make_node("n0"))
    port = _free_port()
    sched = cmd_scheduler.run(
        server=server, healthz_port=port, block=False, device="cpu"
    )
    try:
        server.create("pods", make_pod("p"))
        deadline = time.time() + 15
        while time.time() < deadline:
            if server.get("pods", "default", "p").spec.node_name:
                break
            time.sleep(0.02)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5
        ).read()
        assert body == b"ok"
        # default: Prometheus exposition text (legacyregistry wire form)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5
        ).read().decode()
        assert "# TYPE schedule_attempts_total counter" in text
        assert 'schedule_attempts_total{result="scheduled"}' in text
        # JSON via content negotiation
        m = json.loads(
            urllib.request.urlopen(
                urllib.request.Request(
                    f"http://127.0.0.1:{port}/metrics",
                    headers={"Accept": "application/json"},
                ),
                timeout=5,
            ).read()
        )
        assert any("schedule_attempts_total" in k for k in m)
        # debug reset handler (DELETE /metrics)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/metrics", method="DELETE"
        )
        urllib.request.urlopen(req, timeout=5)
        text2 = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5
        ).read().decode()
        assert "schedule_attempts_total" not in text2
    finally:
        sched.stop()


def _lease_cfg(identity: str) -> LeaderElectionConfig:
    return LeaderElectionConfig(
        identity=identity,
        lease_duration=1.5,
        renew_deadline=1.0,
        retry_period=0.2,
    )


def test_cmd_run_with_election_standby_promotes_and_binds():
    """cmd/scheduler.run with leader election configured starts the
    process as a warm standby behind a shared Cacher and promotes on the
    (instant) first-replica win; the SIGUSR2 dump carries the HA
    section."""
    store = ChaosStore()
    pool = NodeAgentPool(store, housekeeping_interval=0.1)
    for i in range(4):
        pool.add_node(f"cmd-{i}")
    pool.start()
    cfg = KubeSchedulerConfiguration()
    cfg.leader_election = _lease_cfg("cmd-replica-0")
    sched = cmd_scheduler.run(
        server=store, config=cfg, healthz_port=0, block=False, device="cpu"
    )
    try:
        assert type(sched.server).__name__ == "Cacher"
        assert wait_until(
            lambda: sched._elector.is_leader and sched._sched_thread is not None,
            15,
        ), "run() never promoted the first replica"
        assert sched._bind_fence is not None, "promotion armed no fence"
        for i in range(10):
            store.create("pods", make_pod(f"cmd-p-{i}"))
        assert wait_until(lambda: _bound_count(store) == 10, 30)
        dump = CacheDebugger(sched).dump()
        assert "scheduler-HA / leader-election state" in dump
        assert "scheduler_ha_role" in dump
        assert_bind_invariants(store)
    finally:
        sched._elector.stop()
        sched.stop()  # also tears down the run()-owned Cacher
        pool.stop()


def test_cmd_run_with_tune_policy_runs_the_gym_beside_the_wave_path():
    """tune_policy=True: run() starts a PolicyTuner that records the wave
    path's batches and makes gym passes; the dump carries the policy-gym
    section; stopping the tuner detaches the recorder, and sched.stop()
    stops the run()-owned Cacher."""
    server = APIServer()
    for i in range(4):
        server.create("nodes", make_node(f"g{i}"))
    passes0 = metrics.counter(COUNTER_GYM_PASSES)
    sched = cmd_scheduler.run(
        server=server, config=KubeSchedulerConfiguration(tune_policy=True),
        healthz_port=0, block=False, device="cpu",
    )
    tuner = sched._tuner
    try:
        assert sched.cfg.use_wave and sched.wave_recorder is tuner.ring
        for i in range(12):
            server.create("pods", make_pod(f"g-p-{i}"))
        assert wait_until(lambda: _bound_count(server) == 12, 30)
        assert wait_until(lambda: len(tuner.ring) >= 1, 10)
        assert {r.path for r in tuner.ring.snapshot()} == {"wave"}
        assert wait_until(
            lambda: metrics.counter(COUNTER_GYM_PASSES) > passes0, 15
        ), "the gym made no pass"
        assert "Dump of policy-gym (self-tuning scheduler) state:" in (
            CacheDebugger(sched).dump()
        )
    finally:
        tuner.stop()
        sched.stop()
    assert sched.wave_recorder is None
    assert sched._owned_read_cache is sched.server
    assert sched.server._stop.is_set()


def test_main_maps_platform_to_device(monkeypatch):
    calls = []
    monkeypatch.setattr(cmd_scheduler, "run", lambda **kw: calls.append(kw))
    assert cmd_scheduler.main(["--platform", "cpu", "--tune-policy"]) == 0
    assert cmd_scheduler.main(["--healthz-port", "0"]) == 0
    assert cmd_scheduler.main(["--platform", "cuda"]) == 0
    assert [c["device"] for c in calls] == ["cpu", None, None]
    assert [c["config"].tune_policy for c in calls] == [True, False, False]
