"""The port stands alone: no module of kubernetes_tpu_torch, and nothing
chip_smoke.py imports, reaches jax or any module of the JAX package; and
the port's entry points refuse to run on the CPU unless asked to.

The import check runs in a subprocess because tests/conftest.py imports jax
into every test process.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import kubernetes_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
# the data-plane defense slice's and the capacity-planning slice's
# modules are among them
for new in ("parallel.sharded", "parallel.mesh", "parallel.distributed",
            "ops.hostcallback",
            "scheduler.antientropy", "testing.device_faults",
            "autoscaler", "autoscaler.planner", "autoscaler.controller",
            "descheduler", "descheduler.planner", "descheduler.executor",
            "kubelet", "kubelet.kubelet", "kubemark", "kubemark.hollow_node",
            "proxy", "controller.nodelifecycle", "controller.replicaset",
            # the policy-gym slice's
            "tuner.waves", "tuner.candidates", "tuner.scoring",
            "tuner.controller", "cmd", "cmd.scheduler",
            "scheduler.cache.debugger", "utils.debugserver", "api.protocodec",
            "apiserver", "apiserver.cacher", "apiserver.rest",
            "apiserver.client", "apiserver.frontend", "apiserver.flowcontrol",
            "apiserver.watchcodec", "apiserver.admission", "apiserver.auth",
            "apiserver.audit", "apiserver.webhook", "apiserver.crdschema",
            "apiserver.nodeauth", "relay", "relay.publisher", "relay.ring",
            "relay.worker", "controller.base", "controller.resourcequota",
            # the control-plane slice's
            "runtime.wal", "runtime.replication", "runtime.backup", "native",
            "utils.cron", "controller.manager", "controller.attachdetach",
            "controller.bootstrap", "controller.certificates",
            "controller.cloud", "controller.cronjob", "controller.daemonset",
            "controller.deployment", "controller.disruption",
            "controller.endpoints", "controller.endpointslice",
            "controller.garbagecollector", "controller.hpa", "controller.job",
            "controller.namespace", "controller.nodeipam", "controller.podgc",
            "controller.pv_binder", "controller.rbac",
            "controller.serviceaccount", "controller.statefulset",
            "controller.ttl", "controller.volume_expand", "kubelet.cm",
            "kubelet.csi", "kubelet.devicemanager", "kubelet.eviction",
            "kubelet.processruntime", "kubelet.volumemanager", "kubelet.cri",
            "kubelet.cri.wire", "kubelet.cri.api_pb2", "cmd.kubeadm",
            "cmd.kubectl", "cmd.apiserver", "cmd.backup",
            "cmd.controller_manager", "cmd.cloud_controller_manager",
            "cmd.hollow_node", "testing.netchaos", "testing.netchaos_procs",
            "testing.tlsutil", "testing.diskfaults", "testing.fake_cache",
            "testing.framework_helpers", "testing.wrappers",
            # the soak slice's
            "perf.soak"):
    assert pkg.__name__ + "." + new in names, new
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its top level only; main() needs a card)
leaked = sorted(
    k for k in sys.modules
    if k == "kubernetes_tpu" or k.startswith("kubernetes_tpu.")
)
assert not leaked, leaked
assert sys.modules.get("jax") is None
print(len(names))
"""


def _run(code: str, **env):
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
        capture_output=True,
        text=True,
        timeout=240,
    )


def test_port_imports_neither_jax_nor_the_reference_package():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    # every module walked: the wave-path slice's 24, the Scheduler
    # slice's copies and ports (API server, client, runtime, queue,
    # framework and plugins, cache, scheduler, harness, tuner surface)
    # the data-plane defense slice's (parallel, the host-callback
    # registry, the auditor, the fault injector) and the capacity-planning
    # slice's (autoscaler, descheduler, kubelet, kubemark, proxy and the
    # controllers they need) and the policy-gym slice's (the gym, the
    # process entry, the debugger, apiserver/, relay/) and the
    # control-plane slice's (WAL, replication, backup, every controller,
    # the rest of the kubelet, the process entries, the test rigs)
    assert int(proc.stdout.strip().splitlines()[-1]) >= 179


def _bound_names(tree) -> set:
    """Every name a module binds at any depth: defs, classes, assignment
    targets and imports (what ``from pkg import name`` may ask for)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _module_file(parts):
    """The port's file for a dotted module path (as parts), or None."""
    base = ROOT.joinpath(*parts)
    for f in (base.with_suffix(".py"), base / "__init__.py"):
        if f.is_file():
            return f
    return None


def dangling_imports(pkg_root: Path) -> list:
    """Every import of the package, relative or by its absolute name, at
    any depth of any module (lazy imports inside functions included),
    that names a module the package does not have, or a name that the
    module it reads from neither binds nor holds as a submodule."""
    pkg = pkg_root.name
    bad = []
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(ROOT)
        here = list(rel.parent.parts)  # the package this module is in
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = here[: len(here) - (node.level - 1)]
                    if node.level - 1 > len(here) - 1:
                        bad.append(f"{rel}:{node.lineno}: beyond the package")
                        continue
                    mod = base + (node.module.split(".") if node.module else [])
                elif node.module and node.module.split(".")[0] == pkg:
                    mod = node.module.split(".")
                else:
                    continue
                targets.append((mod, [a.name for a in node.names]))
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == pkg:
                        targets.append((a.name.split("."), []))
            for mod, names in targets:
                f = _module_file(mod)
                if f is None:
                    bad.append(f"{rel}:{node.lineno}: no module {'.'.join(mod)}")
                    continue
                bound = None
                for name in names:
                    if name == "*" or _module_file(mod + [name]) is not None:
                        continue
                    if bound is None:
                        bound = _bound_names(ast.parse(f.read_text()))
                    if name not in bound:
                        bad.append(
                            f"{rel}:{node.lineno}: {'.'.join(mod)} has no {name}"
                        )
    return bad


def test_every_import_of_the_port_resolves_to_a_module_of_the_port():
    """Lazy imports run only on their path, so the walk above cannot see
    them: this reads every import statement of the port instead."""
    assert dangling_imports(ROOT / "kubernetes_tpu_torch") == []


def test_chip_smoke_names_no_reference_module():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names, "chip_smoke.py imports nothing?"
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "kubernetes_tpu"), name


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    code = (
        "import torch\n"
        "from kubernetes_tpu_torch.device import resolve_device\n"
        "from kubernetes_tpu_torch.ops.encoding import SnapshotEncoder\n"
        "from kubernetes_tpu_torch.client.apiserver import APIServer\n"
        "from kubernetes_tpu_torch.perf.harness import (\n"
        "    default_config, run_autoscaler_benchmark, run_benchmark,\n"
        "    run_defrag_benchmark, run_hetero_benchmark, run_latency_benchmark,\n"
        "    run_tuner_benchmark)\n"
        "from kubernetes_tpu_torch.cmd import scheduler as cmd_scheduler\n"
        "from kubernetes_tpu_torch.perf.workloads import WorkloadConfig\n"
        "from kubernetes_tpu_torch.scheduler import Scheduler\n"
        "assert not torch.cuda.is_available()\n"
        "assert resolve_device('cpu').type == 'cpu'\n"
        "assert SnapshotEncoder(device='cpu').device.type == 'cpu'\n"
        "assert Scheduler(APIServer(), default_config(), device='cpu').device.type == 'cpu'\n"
        "wl = WorkloadConfig('SchedulingBasic', 2, 0, 1)\n"
        "def scheduler(): return Scheduler(APIServer(), default_config())\n"
        "def bench(): return run_benchmark(wl)\n"
        "def latency(): return run_latency_benchmark(wl, 10.0, n_pods=1)\n"
        "def autoscaler(): return run_autoscaler_benchmark(n_pods=1)\n"
        "def hetero(): return run_hetero_benchmark(n_pods=1)\n"
        "def defrag(): return run_defrag_benchmark()\n"
        "def tuner(): return run_tuner_benchmark()\n"
        "def cmd_run(): return cmd_scheduler.run(APIServer(), healthz_port=0, block=False)\n"
        "def cmd_main(): return cmd_scheduler.main(['--healthz-port', '0'])\n"
        "import tempfile\n"
        "from kubernetes_tpu_torch.cmd import kubeadm\n"
        "from kubernetes_tpu_torch.testing import netchaos_procs\n"
        "tmp = tempfile.mkdtemp()\n"
        "def kubeadm_init(): return kubeadm.init_cluster(tmp + '/i')\n"
        "def kubeadm_standby(): return kubeadm.standby_cluster(('127.0.0.1', 1), tmp + '/s', insecure=True)\n"
        "def kubeadm_main_init(): return kubeadm.main(['init', '--data-dir', tmp + '/m', '--port', '0'])\n"
        "def kubeadm_main_standby(): return kubeadm.main(['standby', '127.0.0.1:1', '--data-dir', tmp + '/n'])\n"
        "def procs_scheduler(): return netchaos_procs.run_scheduler('http://127.0.0.1:1', 'a', 0, 1.5, 1.0, 0.2, False)\n"
        "def procs_main(): return netchaos_procs.main(['scheduler', '--server', 'http://127.0.0.1:1', '--identity', 'a'])\n"
        "for call in (resolve_device, SnapshotEncoder, scheduler, bench, latency,\n"
        "             autoscaler, hetero, defrag, tuner, cmd_run, cmd_main,\n"
        "             kubeadm_init, kubeadm_standby, kubeadm_main_init,\n"
        "             kubeadm_main_standby, procs_scheduler, procs_main):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'device=\"cpu\"' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(f'{call.__name__}() ran without CUDA')\n"
        "import os\n"
        "assert os.listdir(tmp) == [], os.listdir(tmp)  # nothing started\n"
        "print('ok')\n"
    )
    proc = _run(code, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
