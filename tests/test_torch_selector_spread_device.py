"""tests/test_selector_spread_device.py on the port: the device-side
DefaultPodTopologySpread (SelectorSpread) score through the port's
Scheduler on the CPU (device="cpu"), each scenario run through the
reference's Scheduler on the same inputs as well.

(1) Same-service pods on the emptiest node, SelectorSpread weighted up:
    both place the new service pod off n0, on n1 or n2 (n1 and n2 tie, so
    each side's tie noise picks one).
(2) The device wave path and the host-only path pick the same node, n2
    (the only node without a same-service pod), in both packages.
"""

import importlib
import time

import pytest

# this file runs the reference's Scheduler too: leave its process-wide
# metrics as they were found (autouse, module scope)
from test_torch_coscheduling import _reference_metrics_left_as_found  # noqa: F401

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _mods(pkg):
    v1 = importlib.import_module(f"{pkg}.api.objects")
    server_mod = importlib.import_module(f"{pkg}.client.apiserver")
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    config = importlib.import_module(f"{pkg}.scheduler.config")
    return v1, server_mod.APIServer, sched_mod.Scheduler, config


def _node(v1, name):
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, namespace=""),
        status=v1.NodeStatus(capacity={"cpu": "16", "memory": "64Gi", "pods": "110"}),
    )


def _pod(v1, name, labels=None, node="", cpu="100m"):
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, labels=labels or {}),
        spec=v1.PodSpec(node_name=node, containers=[v1.Container(requests={"cpu": cpu})]),
    )


def _scheduler(pkg, server, cfg):
    _v1, _server, Scheduler, _config = _mods(pkg)
    if pkg == "kubernetes_tpu_torch":
        return Scheduler(server, cfg, device="cpu")
    return Scheduler(server, cfg)


def _run_and_get_node(server, pod_name):
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        p = server.get("pods", "default", pod_name)
        if p.spec.node_name:
            return p.spec.node_name
        time.sleep(0.05)
    raise TimeoutError(f"{pod_name} never scheduled")


def _steer(pkg):
    v1, APIServer, _s, config = _mods(pkg)
    server = APIServer()
    for n in ("n0", "n1", "n2"):
        server.create("nodes", _node(v1, n))
    server.create("services", v1.Service(
        metadata=v1.ObjectMeta(name="web"), spec=v1.ServiceSpec(selector={"app": "web"})))
    server.create("pods", _pod(v1, "w0", {"app": "web"}, node="n0", cpu="100m"))
    server.create("pods", _pod(v1, "w1", {"app": "web"}, node="n0", cpu="100m"))
    server.create("pods", _pod(v1, "bulk1", {"app": "bulk"}, node="n1", cpu="8"))
    server.create("pods", _pod(v1, "bulk2", {"app": "bulk"}, node="n2", cpu="8"))
    cfg = config.KubeSchedulerConfiguration(
        use_mesh=False,
        profiles=[config.ProfileConfig(score_weights={"DefaultPodTopologySpread": 100.0})],
    )
    sched = _scheduler(pkg, server, cfg)
    sched.start()
    try:
        server.create("pods", _pod(v1, "new-web", {"app": "web"}))
        return _run_and_get_node(server, "new-web")
    finally:
        sched.stop()


def test_device_selector_spread_steers_away_from_same_service_nodes():
    got = {pkg: _steer(pkg) for pkg in PKGS}
    assert got["kubernetes_tpu"] in ("n1", "n2"), got
    assert got["kubernetes_tpu_torch"] in ("n1", "n2"), (
        f"SelectorSpread should steer off n0 (2 same-service pods); got {got}"
    )


def _differential(pkg, use_device):
    v1, APIServer, _s, config = _mods(pkg)
    server = APIServer()
    for n in ("n0", "n1", "n2"):
        server.create("nodes", _node(v1, n))
    server.create("services", v1.Service(
        metadata=v1.ObjectMeta(name="svc"), spec=v1.ServiceSpec(selector={"app": "x"})))
    server.create("pods", _pod(v1, "x0", {"app": "x"}, node="n0"))
    server.create("pods", _pod(v1, "x1", {"app": "x"}, node="n1"))
    cfg = config.KubeSchedulerConfiguration(
        use_device=use_device,
        use_mesh=False,
        profiles=[config.ProfileConfig(score_weights={"DefaultPodTopologySpread": 100.0})],
    )
    sched = _scheduler(pkg, server, cfg)
    sched.start()
    try:
        server.create("pods", _pod(v1, "newx", {"app": "x"}))
        return _run_and_get_node(server, "newx")
    finally:
        sched.stop()


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_device_matches_host_selector_spread_choice(use_device):
    """Each path in each package picks n2, the reference's choice."""
    ref = _differential("kubernetes_tpu", use_device)
    port = _differential("kubernetes_tpu_torch", use_device)
    assert port == ref == "n2", (ref, port)
