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
for new in ("parallel.sharded", "parallel.mesh", "ops.hostcallback",
            "scheduler.antientropy", "testing.device_faults",
            "autoscaler", "autoscaler.planner", "autoscaler.controller",
            "descheduler", "descheduler.planner", "descheduler.executor",
            "kubelet", "kubelet.kubelet", "kubemark", "kubemark.hollow_node",
            "proxy", "controller.nodelifecycle", "controller.replicaset"):
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
    # controllers they need)
    assert int(proc.stdout.strip().splitlines()[-1]) >= 101


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
        "    run_defrag_benchmark, run_hetero_benchmark, run_latency_benchmark)\n"
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
        "for call in (resolve_device, SnapshotEncoder, scheduler, bench, latency,\n"
        "             autoscaler, hetero, defrag):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'device=\"cpu\"' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(f'{call.__name__}() ran without CUDA')\n"
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
