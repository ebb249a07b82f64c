"""The multi-process mesh of the port (kubernetes_tpu_torch/parallel/
distributed.py, mesh.py, sharded.py), on the CPU: two OS processes join
one gloo process group through a file store and run the node-sharded
kernels over one global mesh, so that every merge and every row read
crosses the process boundary. The counterpart of
tests/test_jax_distributed.py.

That reference test skips on this CPU (its jaxlib has no multiprocess
collectives), so the port's two-process outputs are held to the
reference's sharded kernel on its single-process 8-device CPU mesh
(tests/conftest.py): under SPMD that is the same computation, the same
snapshot split into the same 8 row blocks, merged in the same order.

(a) The reference test's cluster (32 nodes in 4 zones, 8 pods placed, 8
    pods of 500m): 2 processes x 4 virtual entries = the 8-entry mesh,
    through set_sharding and flush. Every pod placed; both processes'
    placed/chosen the same; both EXACTLY equal to the port's
    single-process 8-entry mesh and its single-device kernel with the
    same noise (every output, and every committed block against the
    matching rows); and held to the reference's sharded kernel under
    tests/test_torch_sharding.py's parity rules (masks, counts and
    integer fields exact, scores within rtol = atol = 1e-5, a chosen node
    different only inside a TIE_EPS near-tie).
(b) A random cluster of 120 nodes with pinned pods (one on each process's
    rows, one on no node), score_refresh on, 12 identical big nodes
    straddling the process boundary (rows 58-69 around row 64) so that the
    top-8 merge cuts a tie across it: 2 processes x 2 entries, the wave
    kernel and the serial kernel, every output and every committed local
    block equal to the single-device run exactly.
(c) Mesh construction under a group: rank-major entries with distinct
    global ids, ``first`` and ``local``; gather_snapshot and
    NodeSharded.cpu() refuse another process's part; the Scheduler refuses
    a process-spanning mesh.
(d) A peer that exits in the middle of a batch: the survivor's collective
    raises within the group's timeout; it does not hang.

Each case runs its processes under a subprocess timeout; a hang fails the
test. The workers are this file run as a script (``worker <case> <rank>
<world> <dir>``); they import torch and the port, never jax.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a worker script
    sys.path.insert(0, str(ROOT))

from kubernetes_tpu_torch.ops.batch import encode_pod_batch  # noqa: E402
from kubernetes_tpu_torch.ops.encoding import (  # noqa: E402
    DeviceSnapshot,
    RemoteBlock,
    SnapshotEncoder,
    gather_snapshot,
)
from kubernetes_tpu_torch.ops.lattice import DEFAULT_WEIGHTS, make_schedule_batch  # noqa: E402
from kubernetes_tpu_torch.ops.templates import TemplateCache, build_pair_table  # noqa: E402
from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel  # noqa: E402
from kubernetes_tpu_torch.parallel import distributed  # noqa: E402
from kubernetes_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    MeshDevice,
    make_mesh,
    replicated,
    snapshot_shardings,
    virtual_devices,
)
from kubernetes_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_schedule_batch,
    make_sharded_wave_kernel,
)

CASE_TIMEOUT_S = 180
GROUP_TIMEOUT_S = 60.0
PEER_TIMEOUT_S = 30.0
WAVE_OUT = ("chosen", "placed", "deferred", "feasible_count", "score")
SERIAL_OUT = ("chosen", "score", "feasible_count")
SEED = 11
# (a): the reference test's kernel variant and pod batch
DCN_M_CAND, DCN_WAVES, DCN_PODS = 32, 4, 8
# (b)
RAND_NODES, RAND_M_CAND, RAND_WAVES, RAND_PODS, TIED = 120, 8, 4, 16, range(58, 70)


def objects(pkg):
    """(objects module, make_node, make_pod) of package `pkg`'s API, as
    tests/test_lattice_smoke.py makes them."""
    o = importlib.import_module(f"{pkg}.api.objects")

    def node(name, cpu="4", mem="32Gi", labels=None):
        return o.Node(
            metadata=o.ObjectMeta(name=name, namespace="", labels=labels or {}),
            spec=o.NodeSpec(),
            status=o.NodeStatus(allocatable={"cpu": cpu, "memory": mem, "pods": 110}),
        )

    def pod(name, cpu="1", mem="1Gi", labels=None, **spec_kw):
        return o.Pod(
            metadata=o.ObjectMeta(name=name, namespace="default", labels=labels or {}),
            spec=o.PodSpec(
                containers=[o.Container(requests={"cpu": cpu, "memory": mem})], **spec_kw
            ),
        )

    return o, node, pod


def dcn_cluster(pkg, enc):
    """tests/test_jax_distributed.py's worker cluster; returns its pods."""
    _o, node, pod = objects(pkg)
    for i in range(32):
        enc.add_node(node(f"n{i}", cpu="4", labels={"zone": f"z{i % 4}"}))
    for i in range(8):
        enc.add_pod(f"n{i}", pod(f"pre-{i}", cpu="1", labels={"app": "w"}))
    return [pod(f"p{i}", cpu="500m") for i in range(DCN_PODS)]


def random_cluster(enc, seed=SEED):
    """120 random nodes in 4 zones with 40 random placed pods, and 16
    pending pods: plain ones that tie on the identical big nodes TIED,
    zone anti-affinity, zone spread, a node selector, a big pod, and
    pods pinned to a row of each process and to no node."""
    o, node, pod = objects("kubernetes_tpu_torch")
    sel = importlib.import_module("kubernetes_tpu_torch.api.selectors").LabelSelector
    rng = np.random.default_rng(seed)
    for i in range(RAND_NODES):
        if i in TIED:
            enc.add_node(node(f"n{i}", cpu="64", mem="256Gi", labels={"zone": "z0", "disk": "ssd"}))
        else:
            enc.add_node(node(
                f"n{i}", cpu=str(int(rng.choice([2, 4, 8]))),
                labels={"zone": f"z{int(rng.integers(4))}",
                        "disk": str(rng.choice(["ssd", "hdd"]))},
            ))
    rows = [i for i in range(RAND_NODES) if i not in TIED]
    for j in range(40):
        enc.add_pod(
            f"n{int(rng.choice(rows))}",
            pod(f"pre-{j}", cpu=str(rng.choice(["500m", "1"])),
                labels={"app": str(rng.choice(["web", "db"]))}),
        )
    anti = o.Affinity(pod_anti_affinity=o.PodAntiAffinity(required=(
        o.PodAffinityTerm(label_selector=sel.make(match_labels={"app": "db"}),
                          topology_key="zone"),
    )))
    tsc = o.TopologySpreadConstraint(
        max_skew=2, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=sel.make(match_labels={"app": "web"}),
    )
    pods = [pod(f"plain-{i}", cpu="1") for i in range(6)]
    pods += [pod(f"anti-{i}", labels={"app": "db"}, affinity=anti) for i in range(2)]
    pods += [pod(f"spread-{i}", labels={"app": "web"}, topology_spread_constraints=[tsc])
             for i in range(2)]
    pods += [
        pod("ssd", cpu="500m", node_selector={"disk": "ssd"}),
        pod("big", cpu="6"),
        pod("pin-low", node_name="n5"),
        pod("pin-high", node_name="n100"),
        pod("pin-full", node_name="n100", cpu="64"),
        pod("ghost", node_name="nowhere"),
    ]
    assert len(pods) == RAND_PODS
    return pods


def weights():
    return torch.tensor(DEFAULT_WEIGHTS)


def wave_inputs(enc, pods, pad_to):
    eb = TemplateCache(enc).encode(pods, pad_to=pad_to)
    pt, _ = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    return eb, pt


def random_noise(p, m, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.random((p, m), dtype=np.float32))


def local_blocks(snap) -> dict:
    """{shard: {field: tensor}} of the blocks this process holds."""
    return {s: dict(zip(DeviceSnapshot._fields, blk)) for s, blk in snap.local}


def local_parts(ns) -> dict:
    return {s: p for s, p in enumerate(ns.parts) if p is not None}


# -- the workers --------------------------------------------------------------


def _expect_raise(fn, what: str) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{what} did not raise")


def worker_main(case: str, rank: int, world: int, tmp: Path) -> None:
    distributed.initialize(
        "file://" + str(tmp / "store"), world, rank, "gloo",
        timeout_s=PEER_TIMEOUT_S if case == "peer_exit" else GROUP_TIMEOUT_S,
    )
    if case == "peer_exit":
        return peer_exit_worker(rank)
    out = {"rank": rank, "process_count": distributed.process_count(),
           "process_index": distributed.process_index()}

    # (c) the mesh under the group
    entries = virtual_devices("cpu", 4)
    mesh = make_mesh(entries)
    out["entries"] = [tuple(e[:1]) + (str(e.device), e.process) for e in entries]
    out["mesh"] = [(e.id, str(e.device), e.process) for e in mesh.devices]
    out["local"] = [e.id for e in mesh.local]
    out["first"] = str(mesh.first)
    out["distributed"] = mesh.distributed

    # (a) the reference test's cluster on 2 x 4 entries through set_sharding
    enc = SnapshotEncoder(device="cpu")
    pods = dcn_cluster("kubernetes_tpu_torch", enc)
    eb, pt = wave_inputs(enc, pods, DCN_PODS)
    enc.set_sharding(snapshot_shardings(mesh), replicated(mesh))
    snap = enc.flush()
    out["a_remote"] = [
        (s, tuple(b)) for s, b in enumerate(snap.blocks) if isinstance(b, RemoteBlock)
    ]
    noise = torch.load(tmp / "noise_a.pt")
    kern = make_sharded_wave_kernel(enc.cfg.v_cap, DCN_M_CAND, DCN_WAVES, 1.0, mesh)
    snap, res = kern.with_noise(snap, eb.batch, pt, weights(), noise)
    out["a"] = {f: getattr(res, f) for f in WAVE_OUT}
    out["a_masks"] = {f: local_parts(getattr(res, f)) for f in ("resolvable_tpl", "feasible_tpl")}
    out["a_blocks"] = local_blocks(snap)
    # (c) reads of another process's rows refuse; the process's own work
    out["gather_refused"] = _expect_raise(lambda: gather_snapshot(snap), "gather_snapshot")
    out["mask_refused"] = _expect_raise(lambda: res.feasible_tpl.cpu(), "NodeSharded.cpu")
    b = snap.rows
    own = [s * b + 1 for s, _ in snap.local]
    out["gather_own"] = {f: getattr(gather_snapshot(snap, own), f) for f in ("requested", "valid")}

    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler

    out["scheduler_refused"] = _expect_raise(
        lambda: Scheduler(APIServer(), device="cpu", mesh_devices=virtual_devices("cpu", 2)),
        "Scheduler",
    )

    # (b) the random cluster on 2 x 2 entries: serial, then wave
    mesh2 = make_mesh(virtual_devices("cpu", 2))
    enc = SnapshotEncoder(device="cpu")
    pods = random_cluster(enc)
    sb = encode_pod_batch(enc, pods, pad_to=RAND_PODS)
    eb, pt = wave_inputs(enc, pods, RAND_PODS)
    enc.set_sharding(snapshot_shardings(mesh2), replicated(mesh2))
    snap = enc.flush()
    n = snap.n
    sres = make_sharded_schedule_batch(enc.cfg.v_cap, mesh2)(
        snap, sb.batch, weights(), random_noise(RAND_PODS, n, SEED + 1))
    out["b_serial"] = {f: getattr(sres, f) for f in SERIAL_OUT}
    out["b_serial_resolvable"] = local_parts(sres.resolvable)
    kern = make_sharded_wave_kernel(enc.cfg.v_cap, RAND_M_CAND, RAND_WAVES, 1.0, mesh2)
    wnoise = random_noise(RAND_PODS, min(RAND_M_CAND, n), SEED + 2)
    snap, res = kern.with_noise(snap, eb.batch, pt, weights(), wnoise)
    out["b"] = {f: getattr(res, f) for f in WAVE_OUT}
    out["b_masks"] = {f: local_parts(getattr(res, f)) for f in ("resolvable_tpl", "feasible_tpl")}
    out["b_blocks"] = local_blocks(snap)
    torch.save(out, tmp / f"out{rank}.pt")
    distributed.shutdown()


def peer_exit_worker(rank: int) -> None:
    """(d): rank 1 exits at its second collective, mid-batch; rank 0 must
    see its collective raise within the group's timeout."""
    mesh = make_mesh(virtual_devices("cpu", 2))
    enc = SnapshotEncoder(device="cpu")
    pods = random_cluster(enc)
    eb, pt = wave_inputs(enc, pods, RAND_PODS)
    enc.set_sharding(snapshot_shardings(mesh), replicated(mesh))
    snap = enc.flush()
    if rank == 1:
        real, calls = distributed.all_gather, []

        def dying(t):
            calls.append(1)
            if len(calls) == 2:
                os._exit(3)
            return real(t)

        distributed.all_gather = dying
    kern = make_sharded_wave_kernel(enc.cfg.v_cap, RAND_M_CAND, RAND_WAVES, 1.0, mesh)
    t0 = time.monotonic()
    try:
        kern.with_noise(snap, eb.batch, pt, weights(),
                        random_noise(RAND_PODS, min(RAND_M_CAND, snap.n), SEED + 2))
    except RuntimeError as e:
        print(f"PEER_LOST {time.monotonic() - t0:.3f} {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200]}", file=sys.stderr, flush=True)
        raise
    print("BATCH_DONE", file=sys.stderr, flush=True)


# -- the parent side ----------------------------------------------------------


def spawn(case: str, world: int, tmp: Path) -> list:
    """Run `world` workers of `case`; [(rc, stdout, stderr, seconds)] in
    rank order. A worker still running after CASE_TIMEOUT_S fails the
    test (every worker is killed first)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "worker", case, str(rank), str(world), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
        )
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, CASE_TIMEOUT_S - (time.monotonic() - t0)))
            outs.append((p.returncode, out, err, time.monotonic() - t0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {case} workers hung past {CASE_TIMEOUT_S} s")
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two-process run of cases (a)-(c), once for the module, with
    what the parent computes alone: the single-device runs and the
    port's single-process 8-entry mesh."""
    import jax

    tmp = tmp_path_factory.mktemp("dist")
    enc = SnapshotEncoder(device="cpu")
    pods = dcn_cluster("kubernetes_tpu_torch", enc)
    m_c = min(DCN_M_CAND, enc.cfg.n_cap)
    noise = torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(0), (DCN_PODS, m_c), maxval=0.999)))
    torch.save(noise, tmp / "noise_a.pt")
    outs = spawn("main", 2, tmp)
    for rank, (rc, _out, err, _s) in enumerate(outs):
        assert rc == 0, f"worker {rank} exited {rc}:\n{err[-3000:]}"
    workers = [torch.load(tmp / f"out{r}.pt") for r in range(2)]

    # the parent's own runs on the same inputs
    eb, pt = wave_inputs(enc, pods, DCN_PODS)
    snap1, res1 = make_wave_kernel(enc.cfg.v_cap, DCN_M_CAND, DCN_WAVES).with_noise(
        enc.flush(), eb.batch, pt, weights(), noise)
    enc8 = SnapshotEncoder(device="cpu")
    dcn_cluster("kubernetes_tpu_torch", enc8)
    mesh8 = make_mesh(virtual_devices("cpu", 8))
    eb8, pt8 = wave_inputs(enc8, pods, DCN_PODS)
    enc8.set_sharding(snapshot_shardings(mesh8), replicated(mesh8))
    _snap8, res8 = make_sharded_wave_kernel(
        enc8.cfg.v_cap, DCN_M_CAND, DCN_WAVES, 1.0, mesh8
    ).with_noise(enc8.flush(), eb8.batch, pt8, weights(), noise)

    # (b) in the workers' order: both encodings, one flush, serial, wave
    encb = SnapshotEncoder(device="cpu")
    bpods = random_cluster(encb)
    sb = encode_pod_batch(encb, bpods, pad_to=RAND_PODS)
    ebb, ptb = wave_inputs(encb, bpods, RAND_PODS)
    snapb1 = encb.flush()
    n = snapb1.valid.shape[0]
    sres1 = make_schedule_batch(encb.cfg.v_cap)(
        snapb1, sb.batch, weights(), random_noise(RAND_PODS, n, SEED + 1))
    snapb1, resb1 = make_wave_kernel(encb.cfg.v_cap, RAND_M_CAND, RAND_WAVES).with_noise(
        snapb1, ebb.batch, ptb, weights(), random_noise(RAND_PODS, min(RAND_M_CAND, n), SEED + 2))
    return SimpleNamespace(
        workers=workers, snap1=snap1, res1=res1, res8=res8,
        sres1=sres1, snapb1=snapb1, resb1=resb1, encb=encb,
    )


def assert_equal_outputs(want, got: dict, fields, what):
    for f in fields:
        a, b = getattr(want, f), got[f]
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {f}"


def assert_parts_equal(full: torch.Tensor, parts: dict, rows: int, what: str):
    """Each local part equals its columns of the full [..., N] mask."""
    assert parts, what
    for s, p in parts.items():
        assert torch.equal(full[..., s * rows:(s + 1) * rows], p), f"{what}: part {s}"


def assert_blocks_equal(snap, blocks: dict, rows: int, what: str):
    """Each committed local block equals the single-device snapshot's rows."""
    for s, blk in blocks.items():
        for f, t in blk.items():
            want = getattr(snap, f)
            if f not in ("eterm_topo_key", "eterm_kind", "band_prio"):
                want = want[s * rows:(s + 1) * rows]
            assert want.dtype == t.dtype and torch.equal(want, t), f"{what}: block {s} {f}"


def assembled(workers, key: str, masks_key: str, blocks_key: str):
    """One process's replicated outputs with the masks and the committed
    snapshot assembled from both processes' local parts: what the
    reference's parity rules read."""
    res = SimpleNamespace(**workers[0][key])
    for f in ("resolvable_tpl", "feasible_tpl"):
        parts = {**workers[0][masks_key][f], **workers[1][masks_key][f]}
        setattr(res, f, torch.cat([parts[s] for s in sorted(parts)], dim=-1))
    blocks = {**workers[0][blocks_key], **workers[1][blocks_key]}
    snap = DeviceSnapshot(**{
        f: (blocks[0][f] if f in ("eterm_topo_key", "eterm_kind", "band_prio")
            else torch.cat([blocks[s][f] for s in sorted(blocks)]))
        for f in DeviceSnapshot._fields
    })
    return res, snap


def test_two_process_wave_kernel_matches_one_process_and_the_reference(run):
    """(a) The counterpart of test_two_process_distributed_wave_kernel."""
    from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
    from kubernetes_tpu.ops.templates import TemplateCache as RefTemplateCache
    from kubernetes_tpu.ops.templates import build_pair_table as ref_build_pair_table
    from kubernetes_tpu.parallel import mesh as ref_mesh
    from kubernetes_tpu.parallel.sharded import make_sharded_wave_kernel as ref_kernel
    import jax

    import test_torch_wavelattice as tw

    w0, w1 = run.workers
    for w in (w0, w1):
        assert bool(w["a"]["placed"].all()), w["a"]["placed"]
    # SPMD: both processes computed the same placements
    for f in WAVE_OUT:
        assert torch.equal(w0["a"][f], w1["a"][f]), f
    rows = run.snap1.valid.shape[0] // 8
    for r, w in enumerate((w0, w1)):
        for want, what in ((run.res1, "single device"), (run.res8, "one-process mesh")):
            assert_equal_outputs(want, w["a"], WAVE_OUT, f"process {r} vs {what}")
        for f in ("resolvable_tpl", "feasible_tpl"):
            assert_parts_equal(getattr(run.res1, f), w["a_masks"][f], rows, f"process {r} {f}")
            assert torch.equal(getattr(run.res1, f), getattr(run.res8, f).cpu()), f
        assert_blocks_equal(run.snap1, w["a_blocks"], rows, f"process {r}")
        assert sorted(w["a_blocks"]) == ([0, 1, 2, 3] if r == 0 else [4, 5, 6, 7])
        assert [s for s, _ in w["a_remote"]] == ([4, 5, 6, 7] if r == 0 else [0, 1, 2, 3])

    # the reference's sharded kernel on its 8-device mesh, same noise
    renc = RefEncoder()
    rpods = dcn_cluster("kubernetes_tpu", renc)
    reb = RefTemplateCache(renc).encode(rpods, pad_to=DCN_PODS)
    rpt, _ = ref_build_pair_table(renc, reb.tpl_np, reb.num_templates)
    mesh = ref_mesh.make_mesh()
    assert len(jax.devices()) == 8
    renc.set_sharding(ref_mesh.snapshot_shardings(mesh), ref_mesh.replicated(mesh))
    rsnap, rres = jax.device_get(
        ref_kernel(renc.cfg.v_cap, DCN_M_CAND, DCN_WAVES, 1.0, mesh)(
            renc.flush(), reb.batch, rpt, np.asarray(DEFAULT_WEIGHTS), jax.random.PRNGKey(0)
        )
    )
    assert bool(np.asarray(rres.placed).all())
    for key in (0, 1):
        res, snap = assembled([run.workers[key], run.workers[1 - key]], "a", "a_masks", "a_blocks")
        diff = tw.assert_tie_only(rres, res, reb.pod_tpl_np)
        tw.assert_snapshot_parity(
            rsnap, snap, diff, rres, res, reb.tpl_np, reb.pod_tpl_np, reb.pod_band_np
        )


def test_random_cluster_wave_kernel_across_processes_equals_one_device(run):
    """(b) wave: pinned pods on both processes' rows and on none,
    score_refresh, a top-8 tie cut across the process boundary."""
    rows = run.snapb1.valid.shape[0] // 4
    assert min(TIED) < 2 * rows <= max(TIED), "the tie must straddle the process boundary"
    for r, w in enumerate(run.workers):
        assert_equal_outputs(run.resb1, w["b"], WAVE_OUT, f"process {r}")
        for f in ("resolvable_tpl", "feasible_tpl"):
            assert_parts_equal(getattr(run.resb1, f), w["b_masks"][f], rows, f"process {r} {f}")
        assert_blocks_equal(run.snapb1, w["b_blocks"], rows, f"process {r}")
        assert sorted(w["b_blocks"]) == ([0, 1] if r == 0 else [2, 3])
    chosen = run.resb1.chosen.tolist()
    names = [p.metadata.name for p in random_cluster(SnapshotEncoder(device="cpu"))]
    row = run.encb._row_by_name
    assert chosen[names.index("pin-low")] == row["n5"]
    assert chosen[names.index("pin-high")] == row["n100"] >= 2 * rows
    assert not bool(run.resb1.placed[names.index("ghost")])
    plain = [chosen[i] for i, nm in enumerate(names) if nm.startswith("plain-")]
    assert set(plain) <= set(TIED) and min(plain) < 2 * rows <= max(TIED)


def test_random_cluster_serial_kernel_across_processes_equals_one_device(run):
    """(b) serial: every output and resolvable's local parts."""
    rows = run.snapb1.valid.shape[0] // 4
    for r, w in enumerate(run.workers):
        assert_equal_outputs(run.sres1, w["b_serial"], SERIAL_OUT, f"process {r}")
        assert_parts_equal(run.sres1.resolvable, w["b_serial_resolvable"], rows, f"process {r}")
    chosen = run.sres1.chosen
    assert bool(((chosen >= 0) & (chosen < 2 * rows)).any()) and bool((chosen >= 2 * rows).any())


def test_process_mesh_is_rank_major_with_global_ids(run):
    """(c) Each process's 4 entries get global ids rank * 4 + i; the mesh
    lists both processes' in rank order, the same on both; each process's
    first and local entries are its own."""
    w0, w1 = run.workers
    assert (w0["process_count"], w0["process_index"]) == (2, 0)
    assert (w1["process_count"], w1["process_index"]) == (2, 1)
    assert w0["entries"] == [(i, "cpu", 0) for i in range(4)]
    assert w1["entries"] == [(4 + i, "cpu", 1) for i in range(4)]
    assert w0["mesh"] == w1["mesh"] == [(i, "cpu", i // 4) for i in range(8)]
    assert w0["local"] == [0, 1, 2, 3] and w1["local"] == [4, 5, 6, 7]
    assert w0["first"] == w1["first"] == "cpu"
    assert w0["distributed"] and w1["distributed"]


def test_reads_of_another_processes_rows_refuse(run):
    """(c) gather_snapshot of every row and NodeSharded.cpu() raise,
    naming the owning process; a gather of the process's own rows reads
    them (equal to the single-device snapshot's)."""
    rows = run.snap1.valid.shape[0] // 8
    for r, w in enumerate(run.workers):
        assert f"live in process {1 - r}" in w["gather_refused"], w["gather_refused"]
        assert "lives in another process" in w["mask_refused"], w["mask_refused"]
        own = [s * rows + 1 for s in range(4 * r, 4 * r + 4)]
        for f, t in w["gather_own"].items():
            assert torch.equal(getattr(run.snap1, f)[own], t), f


def test_scheduler_refuses_a_process_spanning_mesh(run):
    """(c) In a worker of the 2-process group, and here with entries of
    two processes and no group: the Scheduler raises and says why."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import Scheduler

    for w in run.workers:
        assert "does not run a mesh that spans processes" in w["scheduler_refused"]
    entries = [MeshDevice(0, torch.device("cpu"), 0), MeshDevice(1, torch.device("cpu"), 1)]
    with pytest.raises(ValueError, match="spans processes"):
        Scheduler(APIServer(), device="cpu", mesh_devices=entries)


def test_peer_exit_mid_batch_raises_within_the_group_timeout(tmp_path):
    """(d) Rank 1 exits at its second collective; rank 0's wave batch
    raises (exit code non-zero, the error printed) well inside
    CASE_TIMEOUT_S, at most the group's timeout after the loss."""
    (rc0, _o0, err0, _s0), (rc1, _o1, _err1, _s1) = spawn("peer_exit", 2, tmp_path)
    assert rc1 == 3
    assert rc0 != 0, err0[-2000:]
    lost = [line for line in err0.splitlines() if line.startswith("PEER_LOST")]
    assert lost, err0[-2000:]
    assert float(lost[0].split()[1]) <= PEER_TIMEOUT_S + 5.0, lost[0]
    assert "BATCH_DONE" not in err0


# -- one process --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64, torch.float32, torch.uint8])
def test_pack_and_unpack_round_trip_every_dtype_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(3)
    vals = [
        (torch.rand((3, 5), generator=g) * 100 - 50).to(dtype),
        torch.tensor(7).to(dtype),  # a 0-dim value (the argmax merge)
        torch.empty((0, 4), dtype=dtype),
        (torch.rand((7,), generator=g) > 0.5).to(dtype),
    ]
    if dtype == torch.float32:
        vals.append(torch.tensor([-0.0, float("nan"), float("inf")]))
    buf = distributed.pack(vals)
    assert buf.dtype == torch.uint8 and buf.numel() == distributed.packed_size(vals)
    assert buf.numel() % 8 == 0
    for a, b in zip(vals, distributed.unpack(buf, vals)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8) if a.numel() else a,
                           b.reshape(-1).view(torch.uint8) if b.numel() else b)


def test_a_mesh_in_one_process_is_unchanged():
    """No group: every entry is local, the first is entry 0's device, the
    merges are local (``distributed`` False), and entries of two
    processes are refused without a group."""
    assert not distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    mesh = make_mesh(virtual_devices("cpu", 4))
    assert not mesh.distributed and mesh.local == mesh.devices
    assert [e.id for e in mesh.devices] == [0, 1, 2, 3]
    assert mesh.first == torch.device("cpu")
    with pytest.raises(ValueError, match="process group"):
        Mesh([MeshDevice(0, torch.device("cpu"), 0), MeshDevice(1, torch.device("cpu"), 1)])
    with pytest.raises(ValueError, match="rank-major"):
        Mesh([MeshDevice(0, torch.device("cpu"), 1), MeshDevice(1, torch.device("cpu"), 0)],
             distributed=True)


def test_the_backend_is_the_callers_choice():
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("file:///nonexistent", 1, 0, "mpi")
    assert not distributed.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5]))
