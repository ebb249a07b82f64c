"""Drift test: every module the port copied from the reference stays a copy.

The port imports nothing of ``kubernetes_tpu``, so the host-only modules it
needs are COPIED into the same place under ``kubernetes_tpu_torch`` with
only their import lines free to change. This test strips every import
statement (at any depth, with all of its lines) from both files and
requires the rest to be equal, character for character — comments and
docstrings included. A copy that differs in anything else fails. A line
that starts a module of the package in a new process (``"-m",
"kubernetes_tpu.relay.worker"``) is an import by name and is stripped too.

Three kinds of copy:
* whole modules (``WHOLE``);
* single definitions copied into a module the port otherwise rewrites
  (``DEFINITIONS``: functions, classes, methods or module constants, each
  equal);
* files that are not Python (``BYTE_EQUAL``: the native WAL sink's C++
  source, the CRI protocol's .proto), byte for byte.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "kubernetes_tpu"
PORT = ROOT / "kubernetes_tpu_torch"

_PLUGINS = sorted(
    str(p.relative_to(REF))
    for p in (REF / "scheduler" / "framework" / "plugins").glob("*.py")
)

WHOLE = [
    # the wave-path slice
    "api/__init__.py",
    "api/objects.py",
    "api/resources.py",
    "api/selectors.py",
    "utils/metrics.py",
    "testing/lockgraph.py",
    # the Scheduler slice
    "api/serialization.py",
    "api/validation.py",
    "api/scheme.py",
    "runtime/__init__.py",
    "runtime/watch.py",
    "runtime/store.py",
    "runtime/consensus.py",
    "client/__init__.py",
    "client/apiserver.py",
    "client/informers.py",
    "client/events.py",
    "client/workqueue.py",
    "client/leaderelection.py",
    "utils/__init__.py",
    "utils/trace.py",
    "utils/tracing.py",
    "utils/featuregate.py",
    "controller/__init__.py",
    "controller/volume_scheduling.py",
    "scheduler/__init__.py",
    "scheduler/queue/__init__.py",
    "scheduler/queue/events.py",
    "scheduler/queue/heap.py",
    "scheduler/queue/scheduling_queue.py",
    "scheduler/framework/__init__.py",
    "scheduler/framework/interface.py",
    "scheduler/framework/runtime.py",
    "scheduler/framework/registry.py",
    *_PLUGINS,
    "scheduler/cache/__init__.py",
    "scheduler/cache/nodeinfo.py",
    "scheduler/cache/cache.py",
    "scheduler/core.py",
    "scheduler/extender.py",
    "scheduler/preemption.py",
    "scheduler/profile.py",
    "scheduler/eventhandlers.py",
    "scheduler/ridethrough.py",
    "scheduler/ha.py",
    "scheduler/config.py",
    "scheduler/apis_config.py",
    "tuner/policy.py",
    "perf/__init__.py",
    # the data-plane defense slice
    "scheduler/antientropy.py",
    "ops/hostcallback.py",
    # the capacity-planning slice (autoscaler and descheduler)
    "perf/workloads.py",
    "autoscaler/__init__.py",
    "autoscaler/nodegroups.py",
    "autoscaler/controller.py",
    "descheduler/__init__.py",
    "descheduler/planner.py",
    "descheduler/executor.py",
    "descheduler/controller.py",
    "controller/evictionbudget.py",
    "controller/nodelifecycle.py",
    "controller/replicaset.py",
    "kubemark/__init__.py",
    "kubemark/hollow_node.py",
    "kubelet/__init__.py",
    "kubelet/kubelet.py",
    "kubelet/runtime.py",
    "proxy/__init__.py",
    "proxy/proxy.py",
    "proxy/userspace.py",
    # the policy-gym slice (the gym and the scheduler's process entry)
    "tuner/__init__.py",
    "tuner/waves.py",
    "tuner/candidates.py",
    "utils/debugserver.py",
    "scheduler/cache/debugger.py",
    "cmd/__init__.py",
    "api/protocodec.py",
    "apiserver/__init__.py",
    "apiserver/cacher.py",
    "apiserver/rest.py",
    "apiserver/client.py",
    "apiserver/frontend.py",
    "apiserver/flowcontrol.py",
    "apiserver/watchcodec.py",
    "apiserver/admission.py",
    "apiserver/auth.py",
    "apiserver/audit.py",
    "apiserver/webhook.py",
    "apiserver/crdschema.py",
    "apiserver/nodeauth.py",
    "relay/__init__.py",
    "relay/publisher.py",
    "relay/ring.py",
    "relay/worker.py",
    "controller/base.py",
    "controller/resourcequota.py",
    # the control-plane slice (WAL, replication, backup, every controller,
    # the rest of the kubelet, the other process entries, test rigs)
    "runtime/wal.py",
    "runtime/replication.py",
    "runtime/backup.py",
    "native/__init__.py",
    "utils/cron.py",
    "controller/attachdetach.py",
    "controller/bootstrap.py",
    "controller/certificates.py",
    "controller/cloud.py",
    "controller/cronjob.py",
    "controller/daemonset.py",
    "controller/deployment.py",
    "controller/disruption.py",
    "controller/endpoints.py",
    "controller/endpointslice.py",
    "controller/garbagecollector.py",
    "controller/hpa.py",
    "controller/job.py",
    "controller/manager.py",
    "controller/namespace.py",
    "controller/nodeipam.py",
    "controller/podgc.py",
    "controller/pv_binder.py",
    "controller/rbac.py",
    "controller/serviceaccount.py",
    "controller/statefulset.py",
    "controller/ttl.py",
    "controller/volume_expand.py",
    "kubelet/cm.py",
    "kubelet/csi.py",
    "kubelet/devicemanager.py",
    "kubelet/eviction.py",
    "kubelet/processruntime.py",
    "kubelet/volumemanager.py",
    "kubelet/cri/__init__.py",
    "kubelet/cri/wire.py",
    "kubelet/cri/api_pb2.py",
    "cmd/kubectl.py",
    "cmd/backup.py",
    "cmd/controller_manager.py",
    "cmd/cloud_controller_manager.py",
    "cmd/hollow_node.py",
    "testing/netchaos.py",
    "testing/tlsutil.py",
    "testing/diskfaults.py",
    "testing/fake_cache.py",
    "testing/framework_helpers.py",
    "testing/wrappers.py",
]

# module -> definitions copied into the port's own module of that name
DEFINITIONS = {
    "ops/encoding.py": [
        "SnapshotEncoder.add_pods_bulk",
        "SnapshotEncoder._master_of",
        "SnapshotEncoder.expected_row_aggregates",
        "SnapshotEncoder.verify_row_aggregates",
        "SnapshotEncoder.drop_pod_entry",
        "SnapshotEncoder.repair_row",
        "SnapshotEncoder.utilization_stats",
        "UtilizationStats",
        "SnapshotEncoder.update_pdb_blocked",
        "SnapshotEncoder.swap_live_snapshot",
        "SnapshotEncoder.ROW_FIELDS",
        "SnapshotEncoder.free_row_indices",
    ],
    "autoscaler/planner.py": [
        "HIST_SIMULATION",
        "COUNTER_SIMULATIONS",
        "pack_weights",
        "VIRTUAL_BIAS_TAINT",
        "SimResult",
        "ScaleUpPlan",
        "plan_scale_up",
        "DrainVerdict",
        "simulate_drain_set",
        "simulate_drain",
    ],
    "ops/lattice.py": ["_BUILTIN_PROFILES", "register_weight_profile"],
    "tuner/scoring.py": [
        "FRAG_WEIGHT",
        "COST_WEIGHT",
        "ENERGY_WEIGHT",
        "fragmentation_score",
        "WaveOutcome",
        "OverlaySnapshot",
        "pad_pow2",
        "rows_for_placements",
        "score_assignment",
        "divergence",
        "replay_wave",
    ],
    "tuner/controller.py": [
        "PolicyTuner.start",
        "PolicyTuner.stop",
        "PolicyTuner._run",
        "PolicyTuner.inject_candidate",
        "PolicyTuner._assemble_candidates",
        "PolicyTuner._decide",
        "PolicyTuner._promote",
        "PolicyTuner._rollback",
    ],
    "cmd/scheduler.py": ["_HealthHandler", "serve_health"],
    # the control-plane slice. kubeadm's init_cluster and standby_cluster
    # take `device` and hand it to the Scheduler, and main() gains
    # --platform on init and standby (the reference's Scheduler picks
    # its JAX backend itself; the port's needs a device).
    "cmd/kubeadm.py": [
        "logger",
        "BOOTSTRAP_TOKEN_SECRET",
        "ADMIN_CONF",
        "ClusterHandle",
        "assemble_security",
        "standby_cluster.StandbyHandle",
        "discover_cluster_info",
        "_request_node_credential",
        "join_node",
        "upgrade_plan",
        "upgrade_apply",
    ],
    # netchaos_procs's scheduler role takes --platform and hands the
    # device to its replica (_Replica, run_scheduler, main): the
    # reference's host-only replica needs no device, the port's Scheduler
    # always resolves one.
    "testing/netchaos_procs.py": [
        "logger",
        "_ledger_store",
        "run_apiserver",
        "_BenchStatsHandler",
        "_hollow_watcher_pool",
        "_serve_stats",
        "_relay_fleet_stats",
        "run_frontend",
        "run_follower",
        "_DebugHandler",
    ],
    # the harness's host-only benches: their spawn lines name the port's
    # netchaos_procs, which the strip rule covers
    "perf/harness.py": [
        "ReadpathBenchResult",
        "run_readpath_benchmark",
        "_count_scheduled",
        "_wait_all_scheduled",
        "ServingBenchResult",
        "run_serving_benchmark",
        "RelayServingBenchResult",
        "_proc_cpu_s",
        "run_relay_serving_benchmark",
        "DurabilityBenchResult",
        "run_durability_benchmark",
    ],
}

# files that are not Python, copied byte for byte
BYTE_EQUAL = ["native/walsink.cpp", "kubelet/cri/api.proto"]

# cmd/apiserver.py is a port whose only change is the dropped call to the
# XLA compilation cache (utils/compilation_cache.py has no port): these
# are the lines of the reference's main() that the port leaves out.
_APISERVER_DROPPED = [
    "    # the apiserver itself is host-only, but control-plane helpers it",
    "    # hosts (e.g. an in-process scheduler replica in tests, tooling that",
    "    # imports through this entry) share the process: point JAX at the",
    "    # persistent compilation cache up front so any kernel they compile",
    "    # lands in (or comes from) the shared cache. Safe post-generational",
    "    # snapshot; KTPU_NO_COMPILATION_CACHE=1 opts out.",
    "",
    "    enable_persistent_compilation_cache()",
]

# `python -m <module of the package>` in an argument list
_SPAWN = re.compile(r'"-m", "kubernetes_tpu(_torch)?\.')


def _import_lines(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(range(node.lineno, node.end_lineno + 1))
    return out


def _strip(lines, skip, lo=1, hi=None):
    hi = len(lines) if hi is None else hi
    return "\n".join(
        lines[i - 1] for i in range(lo, hi + 1) if i not in skip
    )


class _Module:
    def __init__(self, path: Path):
        self.src = path.read_text()
        self.lines = self.src.splitlines()
        self.tree = ast.parse(self.src)
        self.skip = _import_lines(self.tree) | {
            i + 1 for i, line in enumerate(self.lines) if _SPAWN.search(line)
        }

    def text(self, node=None) -> str:
        if node is None:
            return _strip(self.lines, self.skip)
        # decorators and the comment block right above belong to a def
        lo = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        while lo > 1 and self.lines[lo - 2].lstrip().startswith("#"):
            lo -= 1
        return _strip(self.lines, self.skip, lo, node.end_lineno)

    def find(self, dotted: str):
        scope = self.tree.body
        node = None
        for part in dotted.split("."):
            node = next(
                (n for n in scope if _name(n) == part), None
            )
            assert node is not None, f"{dotted} not found"
            scope = getattr(node, "body", [])
        return node


def _name(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        t = node.targets[0]
        return t.id if isinstance(t, ast.Name) else None
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return node.target.id
    return None


def _first_difference(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"first difference at stripped line {i + 1}:\n  ref:  {x!r}\n  port: {y!r}"
    return "one side is a prefix of the other"


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copy_differs_only_in_import_lines(rel):
    ref, port = _Module(REF / rel), _Module(PORT / rel)
    a, b = ref.text(), port.text()
    assert a == b, f"{rel}: {_first_difference(a, b)}"


@pytest.mark.parametrize(
    "rel,dotted",
    [(rel, d) for rel, ds in sorted(DEFINITIONS.items()) for d in ds],
)
def test_copied_definition_is_unchanged(rel, dotted):
    ref, port = _Module(REF / rel), _Module(PORT / rel)
    a, b = ref.text(ref.find(dotted)), port.text(port.find(dotted))
    assert a == b, f"{rel}:{dotted}: {_first_difference(a, b)}"


@pytest.mark.parametrize("rel", BYTE_EQUAL)
def test_non_python_copy_is_byte_equal(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def test_apiserver_main_drops_only_the_compilation_cache_call():
    ref, port = _Module(REF / "cmd/apiserver.py"), _Module(PORT / "cmd/apiserver.py")
    a = ref.text(ref.find("main")).splitlines()
    for line in _APISERVER_DROPPED:
        a.remove(line)
    b = port.text(port.find("main")).splitlines()
    assert a == b, _first_difference("\n".join(a), "\n".join(b))


def test_every_module_under_a_copied_directory_is_listed():
    """A module copied later must join a list here: every port module in
    the copied directories is WHOLE or a known port."""
    ported = {
        "scheduler/scheduler.py",
        "scheduler/wavepath.py",
        "tuner/scoring.py",
        "tuner/controller.py",
        "cmd/scheduler.py",
        "perf/harness.py",
        "testing/__init__.py",
        "testing/device_faults.py",
        "autoscaler/planner.py",
        "cmd/kubeadm.py",
        "cmd/apiserver.py",
        "testing/netchaos_procs.py",
    }
    listed = set(WHOLE) | ported
    for d in ("api", "client", "runtime", "utils", "controller", "scheduler",
              "tuner", "perf", "testing", "autoscaler", "descheduler",
              "kubelet", "kubemark", "proxy", "apiserver", "relay", "cmd",
              "native"):
        for p in sorted((PORT / d).rglob("*.py")):
            rel = str(p.relative_to(PORT))
            assert rel in listed, f"{rel} is neither a listed copy nor a port"
