"""tests/test_extender.py on the port: the HTTP extender wiring of the
Scheduler (filter, prioritize, bind delegation, an ignorable failure, a
non-cache-capable extender, an ignored extended resource that skips the
fit check, is_interested), each scenario run through the port's
Scheduler (device="cpu") and the reference's on the same nodes and pods,
each against an in-process extender server of its own. Both must bind the
same way and make the same extender calls (verb, node names, payload
shape)."""

import importlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from test_torch_coscheduling import _reference_metrics_left_as_found  # noqa: F401

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


class _ExtenderHandler(BaseHTTPRequestHandler):
    server_version = "TestExtender/1.0"

    def log_message(self, *args):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        verb = self.path.strip("/").split("/")[-1]
        self.server.calls.append((verb, _call_summary(body)))
        handler = getattr(self.server, f"handle_{verb}", None)
        result = handler(body) if handler else {}
        payload = json.dumps(result).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


def _call_summary(body: dict) -> tuple:
    """What an extender call carried: its top-level keys and the node
    names it named (sorted), or the pod and node of a bind."""
    if "podName" in body:
        return ("bind", body["podName"], body["node"])
    if body.get("nodenames") is not None:
        names = body["nodenames"]
    elif body.get("nodes"):
        names = [n["metadata"]["name"] for n in body["nodes"]["items"]]
    else:
        names = []
    return (tuple(sorted(k for k, v in body.items() if v is not None)), tuple(sorted(names)))


class _Extender:
    """An in-process extender server (one per package run), recording
    every call it answers."""

    def __enter__(self):
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), _ExtenderHandler)
        self.srv.calls = []
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        return self.srv

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


def ext_url(srv) -> str:
    return f"http://127.0.0.1:{srv.server_address[1]}"


class _Pkg:
    def __init__(self, pkg):
        self.pkg = pkg
        self.v1 = importlib.import_module(f"{pkg}.api.objects")
        self.APIServer = importlib.import_module(f"{pkg}.client.apiserver").APIServer
        sched = importlib.import_module(f"{pkg}.scheduler")
        self.Scheduler, self.Config = sched.Scheduler, sched.KubeSchedulerConfiguration
        self.ext = importlib.import_module(f"{pkg}.scheduler.extender")

    def scheduler(self, server, cfg):
        if self.pkg == "kubernetes_tpu_torch":
            return self.Scheduler(server, cfg, device="cpu")
        return self.Scheduler(server, cfg)

    def node(self, name):
        v1 = self.v1
        return v1.Node(
            metadata=v1.ObjectMeta(name=name, namespace=""),
            status=v1.NodeStatus(allocatable={"cpu": "4", "memory": "32Gi", "pods": 110}),
        )

    def pod(self, name, requests=None):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name),
            spec=v1.PodSpec(containers=[v1.Container(requests=requests or {"cpu": "100m"})]),
        )


def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _run(p, n_nodes, extenders, pod):
    """n_nodes nodes, a Scheduler with `extenders`, one pod "p" created:
    the node it is bound to."""
    server = p.APIServer()
    sched = p.scheduler(server, p.Config(extenders=extenders))
    for i in range(n_nodes):
        server.create("nodes", p.node(f"n{i}"))
    sched.start()
    try:
        server.create("pods", pod)
        _wait(lambda: server.get("pods", "default", "p").spec.node_name)
        return server.get("pods", "default", "p").spec.node_name
    finally:
        sched.stop()


def _both(scenario):
    ref, port = (scenario(_Pkg(pkg)) for pkg in PKGS)
    assert port == ref, (ref, port)
    return port


def test_extender_filter_excludes_nodes():
    def scenario(p):
        with _Extender() as ext:
            ext.handle_filter = lambda body: {
                "nodenames": [n for n in body["nodenames"] if n == "n1"],
                "failedNodes": {n: "not n1" for n in body["nodenames"] if n != "n1"},
            }
            cfg = p.ext.ExtenderConfig(url_prefix=ext_url(ext), filter_verb="filter",
                                       node_cache_capable=True)
            node = _run(p, 4, [cfg], p.pod("p"))
            return node, ext.calls

    node, calls = _both(scenario)
    assert node == "n1"
    assert [c[0] for c in calls] == ["filter"]


def test_extender_prioritize_steers_choice():
    def scenario(p):
        with _Extender() as ext:
            ext.handle_prioritize = lambda body: [
                {"host": n, "score": 100 if n == "n2" else 0} for n in body["nodenames"]
            ]
            cfg = p.ext.ExtenderConfig(url_prefix=ext_url(ext), prioritize_verb="prioritize",
                                       weight=10.0, node_cache_capable=True)
            node = _run(p, 4, [cfg], p.pod("p"))
            return node, ext.calls

    node, calls = _both(scenario)
    assert node == "n2"
    assert [c[0] for c in calls] == ["prioritize"]


def test_extender_bind_delegates():
    def scenario(p):
        bound = {}
        with _Extender() as ext:
            server = p.APIServer()

            def handle_bind(body):
                bound[body["podName"]] = body["node"]
                # the external binder writes the binding itself
                server.bind_pods([p.v1.Binding(
                    pod_name=body["podName"], pod_namespace=body["podNamespace"],
                    pod_uid=body["podUID"], target_node=body["node"],
                )])
                return {}

            ext.handle_bind = handle_bind
            cfg = p.Config(extenders=[p.ext.ExtenderConfig(url_prefix=ext_url(ext),
                                                           bind_verb="bind")])
            sched = p.scheduler(server, cfg)
            server.create("nodes", p.node("n0"))
            sched.start()
            try:
                server.create("pods", p.pod("p"))
                _wait(lambda: bound.get("p"))
                _wait(lambda: server.get("pods", "default", "p").spec.node_name)
            finally:
                sched.stop()
            return bound, server.get("pods", "default", "p").spec.node_name, ext.calls

    bound, node, calls = _both(scenario)
    assert bound == {"p": "n0"} and node == "n0"
    assert calls == [("bind", ("bind", "p", "n0"))]


def test_extender_ignorable_failure_does_not_block():
    # an extender at a dead endpoint, ignorable=True: the pod still binds
    def scenario(p):
        cfg = p.ext.ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                                   http_timeout=0.2, ignorable=True)
        node = _run(p, 1, [cfg], p.pod("p"))
        return node

    assert _both(scenario) == "n0"


def test_non_cache_capable_gets_node_objects():
    def scenario(p):
        with _Extender() as ext:
            seen = {}

            def handle_filter(body):
                seen["keys"] = sorted(body)
                names = [n["metadata"]["name"] for n in body["nodes"]["items"]]
                return {"nodes": {"items": [{"metadata": {"name": n}} for n in names if n == "n0"]}}

            ext.handle_filter = handle_filter
            cfg = p.ext.ExtenderConfig(url_prefix=ext_url(ext), filter_verb="filter")
            node = _run(p, 2, [cfg], p.pod("p"))
            return node, seen["keys"], ext.calls

    node, keys, calls = _both(scenario)
    assert node == "n0"
    assert "nodes" in keys and "nodenames" not in keys
    assert calls[0][1][1] == ("n0", "n1")


def test_ignored_extended_resource_skips_fit_check():
    # the pod requests an extender-managed ignoredByScheduler resource no
    # node advertises: the fit check skips it and the extender decides
    def scenario(p):
        with _Extender() as ext:
            ext.handle_filter = lambda body: {"nodenames": ["n0"]}
            cfg = p.ext.ExtenderConfig(
                url_prefix=ext_url(ext), filter_verb="filter", node_cache_capable=True,
                managed_resources=[p.ext.ExtenderManagedResource(
                    name="example.com/gpu", ignored_by_scheduler=True)],
            )
            pod = p.pod("p", requests={"cpu": "100m", "example.com/gpu": "1"})
            node = _run(p, 1, [cfg], pod)
            return node, ext.calls

    node, calls = _both(scenario)
    assert node == "n0"
    assert [c[0] for c in calls] == ["filter"]


def test_is_interested_managed_resources():
    def scenario(p):
        ext = p.ext.HTTPExtender(p.ext.ExtenderConfig(
            url_prefix="http://x",
            managed_resources=[p.ext.ExtenderManagedResource(name="example.com/gpu")],
        ))
        return (
            ext.is_interested(p.pod("p")),
            ext.is_interested(p.pod("q", requests={"cpu": "1", "example.com/gpu": "1"})),
            ext.is_interested(p.pod("r", requests={"cpu": "1", "example.com/other": "1"})),
        )

    assert _both(scenario) == (False, True, False)
