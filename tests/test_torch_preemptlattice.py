"""Victim-selection parity: the port's ``ops/preemptlattice.preempt_select``
(torch, CPU) against the reference's (JAX, CPU), and the port's
``SnapshotEncoder.update_pdb_blocked`` against the reference's.

All six outputs (node, cand, threshold_prio, victims, violations, helpful)
must be exactly equal, values and dtypes, on:

  * the kernel cases of tests/test_preemptlattice.py — the minimal band
    prefix and node ranking (three full nodes of different priorities),
    the PDB budget column deprioritizing a blocked node, and its output
    guards (the port's ``validate_preempt_outputs`` on the same planes);
  * random banded clusters drawn from a numpy seed (full nodes, four
    priority tiers, taints, node selectors, unschedulable nodes,
    exhausted and positive PDB budgets, preemptors of two priorities),
    each run through both packages' own encoders and, separately, through
    the port's kernel on the reference's encoded state (``ops/convert``),
    so a difference there is the kernel's alone.

The PDB column (``m_pdb_blocked``) and the number of rows each refresh
changed must equal the reference's for the same PDB list, through a
budget exhaustion and its recovery.
"""

import importlib

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.batch import encode_pod_batch as ref_encode_pod_batch
from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.preemptlattice import preempt_select as ref_preempt_select
from kubernetes_tpu.ops.preemptlattice import (
    validate_preempt_outputs as ref_validate,
)
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.ops.batch import encode_pod_batch
from kubernetes_tpu_torch.ops.preemptlattice import (
    GUARD_PREEMPT_EMPTY,
    GUARD_PREEMPT_ROW,
    PREEMPT_TOP_K,
    PreemptBatchResult,
    preempt_select,
    validate_preempt_outputs,
)

from test_torch_encoding import PACKAGES, port_encoder, to_numpy

PAD = 16


def _objects(pkg):
    return importlib.import_module(f"{pkg}.api.objects")


def make_node(o, name, cpu="4", labels=None, taints=None, unschedulable=False):
    return o.Node(
        metadata=o.ObjectMeta(name=name, namespace="", labels=labels or {}),
        spec=o.NodeSpec(taints=list(taints or []), unschedulable=unschedulable),
        status=o.NodeStatus(allocatable={"cpu": cpu, "memory": "16Gi", "pods": 32}),
    )


def make_pod(o, name, cpu="1", prio=0, labels=None, node_selector=None, tolerations=None):
    return o.Pod(
        metadata=o.ObjectMeta(name=name, labels=labels or {}),
        spec=o.PodSpec(
            containers=[o.Container(requests={"cpu": cpu})],
            priority=prio,
            node_selector=dict(node_selector or {}),
            tolerations=list(tolerations or []),
        ),
    )


def make_pdb(o, name, app, allowed):
    return o.PodDisruptionBudget(
        metadata=o.ObjectMeta(name=name),
        spec=o.PodDisruptionBudgetSpec(selector={"app": app}),
        status=o.PodDisruptionBudgetStatus(disruptions_allowed=allowed),
    )


def encoders():
    return RefEncoder(), port_encoder()


def run_both(ref_enc, port_enc, ref_pods, port_pods):
    """Encode the preemptors on both sides, run both kernels on their own
    encodings and the port's on the reference's state; every output must
    be equal. Returns the reference's result as numpy."""
    ref_eb = ref_encode_pod_batch(ref_enc, ref_pods, pad_to=PAD)
    port_eb = encode_pod_batch(port_enc, port_pods, pad_to=PAD)
    ref_snap, port_snap = ref_enc.flush(), port_enc.flush()
    want = ref_preempt_select(ref_snap, ref_eb.batch, ref_eb.batch.priority)
    want = PreemptBatchResult(*(np.asarray(x) for x in want))
    got = preempt_select(port_snap, port_eb.batch, port_eb.batch.priority)
    got_k = preempt_select(
        convert.snapshot_from_reference(ref_snap, "cpu"),
        convert.pod_batch_from_reference(ref_eb.batch, "cpu"),
        torch.tensor(np.asarray(ref_eb.batch.priority)),
    )
    for res in (got, got_k):
        for f in PreemptBatchResult._fields:
            a, b = getattr(want, f), to_numpy(getattr(res, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert want.cand.shape == (PAD, PREEMPT_TOP_K)
    return want


def test_minimal_band_prefix_and_node_ranking_match_reference():
    """Three full nodes: prio-0 victims beat prio-5 ones, the prio-50 node
    is never helpful, and the victim count is the whole prio-0 band."""
    encs = encoders()
    pods = []
    for enc, pkg in zip(encs, PACKAGES):
        o = _objects(pkg)
        for n in ("a", "b", "c"):
            enc.add_node(make_node(o, n))
        for i in range(4):
            enc.add_pod("a", make_pod(o, f"la{i}", "1", prio=0))
            enc.add_pod("b", make_pod(o, f"hb{i}", "1", prio=50))
            enc.add_pod("c", make_pod(o, f"mc{i}", "1", prio=5))
        pods.append([make_pod(o, "pre", "2", prio=10)])
    want = run_both(*encs, *pods)
    rows = encs[0].row_names
    assert rows[int(want.node[0])] == "a"
    assert int(want.threshold_prio[0]) == 0 and int(want.victims[0]) == 4
    assert [rows[int(r)] for r in want.cand[0] if r >= 0][:2] == ["a", "c"]


def test_pdb_budget_column_matches_reference():
    """One node's victims are PDB-blocked: the column, the rows each
    refresh changes and the kernel's ranking all match the reference,
    through the budget's exhaustion and its recovery."""
    encs = encoders()
    pods, pdbs = [], []
    for enc, pkg in zip(encs, PACKAGES):
        o = _objects(pkg)
        enc.add_node(make_node(o, "blocked"))
        enc.add_node(make_node(o, "free"))
        for i in range(4):
            enc.add_pod("blocked", make_pod(o, f"pb{i}", "1", labels={"app": "web"}))
            enc.add_pod("free", make_pod(o, f"pf{i}", "1", labels={"app": "db"}))
        pods.append([make_pod(o, "pre", "2", prio=10)])
        pdbs.append((make_pdb(o, "b", "web", 0), make_pdb(o, "b", "web", 2)))
    ref_enc, port_enc = encs
    assert port_enc.update_pdb_blocked([pdbs[1][0]]) == ref_enc.update_pdb_blocked(
        [pdbs[0][0]]
    ) == 1
    np.testing.assert_array_equal(port_enc.m_pdb_blocked, ref_enc.m_pdb_blocked)
    want = run_both(ref_enc, port_enc, *pods)
    assert ref_enc.row_names[int(want.node[0])] == "free"
    assert int(want.violations[0]) == 0
    # the flushed device column equals the masters on both sides
    np.testing.assert_array_equal(
        to_numpy(port_enc.flush().pdb_blocked), np.asarray(ref_enc.flush().pdb_blocked)
    )
    # recovery: the budget refills and the column clears
    assert port_enc.update_pdb_blocked([pdbs[1][1]]) == ref_enc.update_pdb_blocked(
        [pdbs[0][1]]
    ) == 1
    assert port_enc.m_pdb_blocked.sum() == ref_enc.m_pdb_blocked.sum() == 0
    # no exhausted budget and a clear column: nothing to recompute
    assert port_enc.update_pdb_blocked([]) == ref_enc.update_pdb_blocked([]) == 0
    run_both(ref_enc, port_enc, *pods)


@pytest.mark.parametrize(
    "node,victims,n_rows,cand",
    [
        ([0, -1, 2], [2, 0, 1], 3, None),
        ([5], [1], 3, None),
        ([-7], [1], 3, None),
        ([1], [0], 3, None),
        ([1], [1], 3, [[1, 9]]),
        ([-1], None, 3, None),
    ],
)
def test_validate_preempt_outputs_matches_reference(node, victims, n_rows, cand):
    args = [np.array(node, np.int32), None if victims is None else np.array(victims)]
    kw = {} if cand is None else {"cand": np.array(cand, np.int32)}
    want = ref_validate(*args, n_rows, **kw)
    assert validate_preempt_outputs(*args, n_rows, **kw) == want
    assert want in (None, GUARD_PREEMPT_ROW, GUARD_PREEMPT_EMPTY)


APPS = ("web", "db", "cache")


def banded_case(pkg, seed):
    """(nodes, [(node, pod)], pdbs, preemptors) in package `pkg`'s objects:
    full nodes of four priority tiers, drawn from a numpy seed."""
    o = _objects(pkg)
    rng = np.random.RandomState(seed)
    n_nodes = int(rng.choice([6, 10, 14]))
    nodes, placed = [], []
    for i in range(n_nodes):
        taints = (
            [o.Taint("dedicated", "infra", "NoSchedule")] if rng.rand() < 0.15 else []
        )
        cpu = int(rng.choice([2, 4]))
        nodes.append(
            make_node(
                o, f"n{i}", cpu=str(cpu),
                labels={"zone": f"z{int(rng.randint(0, 2))}"},
                taints=taints, unschedulable=bool(rng.rand() < 0.08),
            )
        )
        free = cpu * 1000
        j = 0
        while free >= 500:
            milli = 1000 if free >= 1000 and rng.rand() < 0.5 else 500
            placed.append((
                f"n{i}",
                make_pod(
                    o, f"pre-{i}-{j}", f"{milli}m",
                    prio=int(rng.choice([0, 5, 10, 50])),
                    labels={"app": APPS[int(rng.randint(0, 3))]},
                ),
            ))
            free -= milli
            j += 1
    pdbs = [
        make_pdb(o, f"pdb-{app}", app, int(rng.choice([0, 0, 1])))
        for app in APPS
        if rng.rand() < 0.5
    ]
    preemptors = []
    for k in range(10):
        preemptors.append(
            make_pod(
                o, f"hi-{k}", cpu=str(int(rng.choice([1, 2, 3]))),
                prio=int(rng.choice([20, 100])),
                labels={"app": APPS[int(rng.randint(0, 3))]},
                node_selector=(
                    {"zone": f"z{int(rng.randint(0, 2))}"} if rng.rand() < 0.2 else None
                ),
                tolerations=(
                    [o.Toleration(key="dedicated", operator="Exists")]
                    if rng.rand() < 0.3
                    else None
                ),
            )
        )
    return nodes, placed, pdbs, preemptors


@pytest.mark.parametrize("seed", range(8))
def test_preempt_select_matches_reference_on_random_banded_clusters(seed):
    encs = encoders()
    cases = [banded_case(pkg, seed) for pkg in PACKAGES]
    changed = []
    for enc, (nodes, placed, pdbs, _pre) in zip(encs, cases):
        for n in nodes:
            enc.add_node(n)
        for node_name, pod in placed:
            enc.add_pod(node_name, pod)
        changed.append(enc.update_pdb_blocked(pdbs))
    assert changed[0] == changed[1]
    np.testing.assert_array_equal(encs[1].m_pdb_blocked, encs[0].m_pdb_blocked)
    want = run_both(*encs, cases[0][3], cases[1][3])
    # the case bites: some pods have a candidate node, and the bands differ
    assert (want.node[: len(cases[0][3])] >= 0).any()
    assert len(set(np.asarray(encs[0].flush().band_prio).tolist())) > 2
