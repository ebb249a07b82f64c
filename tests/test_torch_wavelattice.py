"""Wave-kernel parity: the port's ``WaveKernel`` (kubernetes_tpu_torch, CPU)
against the reference's ``make_wave_kernel`` (kubernetes_tpu, JAX on the
CPU) on the reference's OWN encoded state, carried across by
``ops/convert.py`` — so these cases test the kernel alone, not the
encoding — with the tie noise the reference draws from the same key
(``jax.random.uniform(key, (P, m_c), maxval=0.999)``).

Required, per case:
  * exact: placed, deferred, feasible_count, feasible_tpl, resolvable_tpl
    and every integer field of the returned snapshot;
  * float fields (score, eterm_w) within rtol = 1e-5, atol = 1e-5 (the two
    sides may round elementwise score chains differently);
  * chosen equal, except where both nodes are feasible for the pod's
    template and its scores on the two sides lie within TIE_EPS (relative
    to the score's magnitude): a near-tie the rounding may break either
    way. Each such difference is asserted to be a tie, and the snapshot
    comparison then moves the pod's occupancy to the port's node.

The cases are the scenarios of tests/test_wavelattice.py (fit, in-batch
conflict, anti-affinity, affinity carve-out, topology spread, pinned pod,
unknown pinned node, unschedulable) plus the mixed graft cluster, each
with ``use_pallas_fit`` True (the reference's Pallas kernel in interpret
mode; the port's fit_mask wrapper) and False.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    Affinity,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    TopologySpreadConstraint,
)
from kubernetes_tpu.api.selectors import LabelSelector
from kubernetes_tpu.ops.encoding import SnapshotEncoder
from kubernetes_tpu.ops.lattice import DEFAULT_WEIGHTS
from kubernetes_tpu.ops.templates import TemplateCache, build_pair_table
from kubernetes_tpu.ops.wavelattice import DEFAULT_RTC_SHAPE, make_wave_kernel_jit
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.ops.wavelattice import TIE_EPS, make_wave_kernel

from test_lattice_smoke import make_node, make_pod
from test_torch_encoding import build_cluster, feed, to_numpy

P_PAD = 16
M_CAND = 16
N_WAVES = 8
RTOL = ATOL = 1e-5


def assert_tie_only(ref_res, port_res, pod_tpl):
    """Result parity; returns the pods whose chosen node differs (each
    asserted to be a near-tie between two feasible nodes)."""
    for f in ("placed", "deferred", "feasible_count", "feasible_tpl", "resolvable_tpl"):
        a, b = np.asarray(getattr(ref_res, f)), to_numpy(getattr(port_res, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    ref_s, port_s = np.asarray(ref_res.score), to_numpy(port_res.score)
    assert port_s.dtype == ref_s.dtype
    ref_c, port_c = np.asarray(ref_res.chosen), to_numpy(port_res.chosen)
    assert port_c.dtype == ref_c.dtype
    feas = np.asarray(ref_res.feasible_tpl)
    diff = np.flatnonzero(ref_c != port_c)
    for i in diff:
        t, a, b = int(pod_tpl[i]), int(ref_c[i]), int(port_c[i])
        assert a >= 0 and b >= 0, (i, a, b)
        assert feas[t, a] and feas[t, b], (i, a, b)
        assert abs(float(ref_s[i]) - float(port_s[i])) <= TIE_EPS * max(
            1.0, abs(float(ref_s[i]))
        ), (i, ref_s[i], port_s[i])
    same = ref_c == port_c
    np.testing.assert_allclose(port_s[same], ref_s[same], rtol=RTOL, atol=ATOL)
    return diff


def assert_snapshot_parity(ref_snap, port_snap, diff, ref_res, port_res, tpl_np, pod_tpl, pod_band):
    """The returned snapshots agree; for tie pods the reference's commit
    is moved from its node to the port's before comparing."""
    want = {f: np.array(np.asarray(getattr(ref_snap, f))) for f in ref_snap._fields}
    ref_c, port_c = np.asarray(ref_res.chosen), to_numpy(port_res.chosen)
    for i in diff:
        t, band = int(pod_tpl[i]), int(pod_band[i])
        for row, sign in ((int(ref_c[i]), -1), (int(port_c[i]), 1)):
            want["requested"][row] += sign * tpl_np.req[t]
            want["nonzero_req"][row] += sign * tpl_np.nonzero_req[t]
            want["sel_counts"][row] += sign * tpl_np.match_sel[t].astype(np.int32)
            want["eterm_w"][row] += sign * tpl_np.eterm_add[t]
            want["port_counts"][row] += sign * tpl_np.port_mask[t].astype(np.int32)
            want["prio_req"][row, band] += sign * tpl_np.req[t]
    for f in ref_snap._fields:
        a, b = want[f], to_numpy(getattr(port_snap, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def run_both(enc, pods, use_pallas_fit, seed=0, score_refresh=True):
    """Encode with the reference, run both kernels on that state and the
    same noise, and check parity. Returns (ref_res, port_res)."""
    eb = TemplateCache(enc).encode(pods, pad_to=P_PAD)
    pt, _ = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    snap = enc.flush()
    snap_np = jax.device_get(snap)  # before the donating call consumes it
    key = jax.random.PRNGKey(seed)
    weights = jnp.asarray(DEFAULT_WEIGHTS)
    kern = make_wave_kernel_jit(
        enc.cfg.v_cap, M_CAND, N_WAVES, 1.0, use_pallas_fit, score_refresh,
        DEFAULT_RTC_SHAPE, True,
    )
    ref_snap, ref_res = jax.device_get(kern(snap, eb.batch, pt, weights, key))
    enc.invalidate_device()  # the snapshot was donated
    m_c = min(M_CAND, enc.cfg.n_cap)
    noise = np.asarray(jax.random.uniform(key, (P_PAD, m_c), maxval=0.999))

    port_kern = make_wave_kernel(
        enc.cfg.v_cap, M_CAND, N_WAVES, 1.0, use_pallas_fit, score_refresh,
        DEFAULT_RTC_SHAPE, True,
    )
    port_snap, port_res = port_kern.with_noise(
        convert.snapshot_from_reference(snap_np, "cpu"),
        convert.template_batch_from_reference(eb.batch, "cpu"),
        convert.pair_table_from_reference(pt, "cpu"),
        convert.weights_from_reference(DEFAULT_WEIGHTS, "cpu"),
        torch.tensor(noise),
    )
    diff = assert_tie_only(ref_res, port_res, eb.pod_tpl_np)
    assert_snapshot_parity(
        ref_snap, port_snap, diff, ref_res, port_res, eb.tpl_np,
        eb.pod_tpl_np, eb.pod_band_np,
    )
    return ref_res, port_res


def _fit():
    enc = SnapshotEncoder()
    for i in range(4):
        enc.add_node(make_node(f"n{i}", cpu="4"))
    enc.add_pod("n0", make_pod("existing", cpu="3"))
    return enc, [make_pod("p", cpu="2")]


def _in_batch_conflict():
    enc = SnapshotEncoder()
    enc.add_node(make_node("n0", cpu="3"))
    enc.add_node(make_node("n1", cpu="3"))
    return enc, [make_pod("a", cpu="2"), make_pod("b", cpu="2")]


def _anti_affinity():
    enc = SnapshotEncoder()
    for i in range(6):
        enc.add_node(make_node(f"n{i}", labels={"zone": f"z{i % 3}"}))
    anti = Affinity(
        pod_anti_affinity=PodAntiAffinity(
            required=(
                PodAffinityTerm(
                    label_selector=LabelSelector.make(match_labels={"app": "w"}),
                    topology_key="zone",
                ),
            )
        )
    )
    return enc, [make_pod(f"p{i}", labels={"app": "w"}, affinity=anti) for i in range(4)]


def _affinity_carveout():
    enc = SnapshotEncoder()
    enc.add_node(make_node("a", labels={"zone": "z1"}))
    enc.add_node(make_node("b", labels={"zone": "z2"}))
    aff = Affinity(
        pod_affinity=PodAffinity(
            required=(
                PodAffinityTerm(
                    label_selector=LabelSelector.make(match_labels={"app": "g"}),
                    topology_key="zone",
                ),
            )
        )
    )
    return enc, [make_pod(f"p{i}", labels={"app": "g"}, affinity=aff) for i in range(3)]


def _topology_spread():
    enc = SnapshotEncoder()
    for i in range(6):
        enc.add_node(make_node(f"n{i}", labels={"zone": f"z{i % 3}"}))
    tsc = TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector.make(match_labels={"app": "s"}),
    )
    return enc, [
        make_pod(f"p{i}", labels={"app": "s"}, topology_spread_constraints=[tsc])
        for i in range(6)
    ]


def _pinned():
    enc = SnapshotEncoder()
    for i in range(3):
        enc.add_node(make_node(f"n{i}", cpu="2"))
    return enc, [
        make_pod("p", node_name="n1"),
        make_pod("q", node_name="n1", cpu="2"),  # n1 fills: q defers
        make_pod("ghost", node_name="nowhere"),  # unknown node: row -2
        make_pod("free", cpu="1"),
    ]


def _unschedulable():
    enc = SnapshotEncoder()
    enc.add_node(make_node("small", cpu="1"))
    return enc, [make_pod("big", cpu="2")]


def _graft_cluster():
    enc = SnapshotEncoder()
    nodes, prefill, pending = build_cluster("kubernetes_tpu")
    feed(enc, nodes, prefill)
    return enc, pending


SCENARIOS = {
    "fit": _fit,
    "in_batch_conflict": _in_batch_conflict,
    "anti_affinity": _anti_affinity,
    "affinity_carveout": _affinity_carveout,
    "topology_spread": _topology_spread,
    "pinned": _pinned,
    "unschedulable": _unschedulable,
    "graft_cluster": _graft_cluster,
}


@pytest.mark.parametrize("use_pallas_fit", [False, True])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_wave_kernel_matches_reference(name, use_pallas_fit):
    enc, pods = SCENARIOS[name]()
    ref_res, _ = run_both(enc, pods, use_pallas_fit)
    if name == "anti_affinity":  # the scenario's own semantics hold too
        assert int(np.asarray(ref_res.placed).sum()) == 3
    if name == "pinned":
        assert int(np.asarray(ref_res.chosen)[0]) == 1
        assert not bool(np.asarray(ref_res.placed)[2])


@pytest.mark.parametrize("seed", [1, 2])
def test_wave_kernel_matches_reference_without_score_refresh(seed):
    enc, pods = _graft_cluster()
    run_both(enc, pods, True, seed=seed, score_refresh=False)


def test_wave_kernel_tie_noise_from_generator():
    """The public entry draws its noise from a torch.Generator: the same
    seed gives the same placements, and every output keeps its dtype."""
    enc, pods = _graft_cluster()
    eb = TemplateCache(enc).encode(pods, pad_to=P_PAD)
    pt, _ = build_pair_table(enc, eb.tpl_np, eb.num_templates)
    snap_np = jax.device_get(enc.flush())
    kern = make_wave_kernel(enc.cfg.v_cap, M_CAND, N_WAVES)
    outs = []
    for _ in range(2):
        _, res = kern(
            convert.snapshot_from_reference(snap_np, "cpu"),
            convert.template_batch_from_reference(eb.batch, "cpu"),
            convert.pair_table_from_reference(pt, "cpu"),
            convert.weights_from_reference(DEFAULT_WEIGHTS, "cpu"),
            torch.Generator().manual_seed(7),
        )
        outs.append(res)
    assert torch.equal(outs[0].chosen, outs[1].chosen)
    assert outs[0].chosen.dtype == torch.int32
    assert outs[0].feasible_count.dtype == torch.int32
    assert outs[0].score.dtype == torch.float32
    assert int(outs[0].placed.sum()) > 0
