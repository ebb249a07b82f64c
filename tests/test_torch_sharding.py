"""Node-axis sharding in the port (kubernetes_tpu_torch/parallel), on the
CPU: the counterpart of tests/test_sharding.py.

The mesh is ``virtual_devices("cpu", S)`` (S entries with distinct ids on
one CPU device, the port's counterpart of the reference's virtual XLA
devices); the reference runs on its 8-device CPU mesh (tests/conftest.py).

(a) Kernel parity. On the eight scenarios of tests/test_torch_wavelattice.py
    and tests/test_torch_serial_lattice.py's inputs, at meshes of 1, 2, 4
    and 8 entries, the port's node-sharded wave kernel
    (``make_sharded_wave_kernel``) and serial kernel
    (``make_sharded_schedule_batch``):
      * equal the port's single-device kernels on the same snapshot and
        noise EXACTLY, every output and the committed snapshot (the merges
        are exact: the domain sums add integral float32 weights under
        2**24, the rest are maxima, sorts and integer counts);
      * equal the reference's sharded kernels on its 8-device mesh, with
        the same noise, under the single-device parity rules of
        tests/test_torch_wavelattice.py: masks, counts and the snapshot's
        integer fields exact, float scores within rtol = atol = 1e-5, a
        chosen node different only inside a proven TIE_EPS near-tie.
    The reference's own test_sharding.py cluster runs through the
    encoder's ``set_sharding`` upload on both sides.
(b) The boundary cases of the merges: equal-score candidates straddling a
    shard boundary (the top-M keeps global row order), ``m_cand`` larger
    than a shard's rows, exact domain sums over a domain spanning every
    shard, the best node on the last shard, and every merge exercised
    (the counterpart of ``test_sharded_collectives_in_hlo``).
(c) The sharded snapshot in the encoder: row blocks (each its own
    allocation), the dirty-row scatter routed to the owning block,
    copy-on-pin and retirement of every block, the stall watchdog per
    generation, and the readers that take ``gather_snapshot`` (the
    auditor's fetch, the what-if overlay, the victim selection, the
    preemption what-if) answering as on one device.
(d) The Scheduler on an 8-entry mesh: it adopts the mesh and binds, and
    driven batch by batch against the reference's Scheduler on its
    8-device mesh (tests/test_torch_scheduler.py's parity, wave and
    serial) every batch result and binding is equal.
"""

import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.batch import encode_pod_batch as ref_encode_pod_batch
from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.lattice import DEFAULT_WEIGHTS
from kubernetes_tpu.ops.templates import TemplateCache, build_pair_table
from kubernetes_tpu.parallel import make_mesh as ref_make_mesh
from kubernetes_tpu.parallel import mesh as ref_mesh_mod
from kubernetes_tpu.parallel import sharded as ref_sharded
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.ops.batch import encode_pod_batch
from kubernetes_tpu_torch.ops.encoding import (
    DeviceSnapshot,
    ShardedSnapshot,
    SnapshotEncoder,
    gather_snapshot,
)
from kubernetes_tpu_torch.ops.lattice import make_schedule_batch, preempt_whatif, run_local
from kubernetes_tpu_torch.ops.preemptlattice import preempt_select
from kubernetes_tpu_torch.ops.templates import TemplateCache as PortTemplateCache
from kubernetes_tpu_torch.ops.templates import build_pair_table as port_build_pair_table
from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel
from kubernetes_tpu_torch.parallel import (
    make_mesh,
    make_sharded_schedule_batch,
    replicated,
    shard_snapshot,
    snapshot_shardings,
)
from kubernetes_tpu_torch.parallel import sharded
from kubernetes_tpu_torch.parallel.mesh import virtual_devices
from kubernetes_tpu_torch.parallel.sharded import NodeSharded, make_sharded_wave_kernel
from kubernetes_tpu_torch.utils.metrics import metrics

import test_torch_wavelattice as tw
from test_lattice_smoke import make_node, make_pod
from test_torch_serial_lattice import assert_serial_parity, reference_noise

MESHES = [1, 2, 4, 8]
P_PAD, M_CAND, N_WAVES = tw.P_PAD, tw.M_CAND, tw.N_WAVES
RTC = ((0.0, 0.0), (100.0, 10.0))


def vmesh(s):
    return make_mesh(virtual_devices("cpu", s))


def clone(nt):
    return type(nt)(*(t.clone() for t in nt))


def port_inputs(snap_np, eb, pt):
    return (
        convert.snapshot_from_reference(snap_np, "cpu"),
        convert.template_batch_from_reference(eb.batch, "cpu"),
        convert.pair_table_from_reference(pt, "cpu"),
        convert.weights_from_reference(DEFAULT_WEIGHTS, "cpu"),
    )


def assert_wave_equal(single, sharded_out):
    """Every output and the committed snapshot, exactly."""
    (s1, r1), (s2, r2) = single, sharded_out
    for f in ("chosen", "placed", "deferred", "feasible_count", "score"):
        a, b = getattr(r1, f), getattr(r2, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in ("resolvable_tpl", "feasible_tpl"):
        assert isinstance(getattr(r2, f), NodeSharded), f
        assert torch.equal(getattr(r1, f), getattr(r2, f).cpu()), f
    g = gather_snapshot(s2)
    for f in DeviceSnapshot._fields:
        assert torch.equal(getattr(s1, f), getattr(g, f)), f


# -- (a) kernel parity --------------------------------------------------------

_REF_WAVE = {}


def ref_sharded_wave(name, m_cand=M_CAND):
    """The reference's sharded wave kernel on its 8-device mesh, once per
    scenario: (inputs, ref snapshot, ref result, noise)."""
    key = (name, m_cand)
    if key not in _REF_WAVE:
        enc, pods = tw.SCENARIOS[name]()
        eb = TemplateCache(enc).encode(pods, pad_to=P_PAD)
        pt, _ = build_pair_table(enc, eb.tpl_np, eb.num_templates)
        snap_np = jax.device_get(enc.flush())
        mesh = ref_make_mesh()
        assert len(jax.devices()) == 8
        enc.invalidate_device()
        enc.set_sharding(ref_mesh_mod.snapshot_shardings(mesh), ref_mesh_mod.replicated(mesh))
        kern = ref_sharded.make_sharded_wave_kernel(
            enc.cfg.v_cap, m_cand, N_WAVES, 1.0, mesh, False, True, RTC, True
        )
        rkey = jax.random.PRNGKey(0)
        ref_snap, ref_res = jax.device_get(
            kern(enc.flush(), eb.batch, pt, jnp.asarray(DEFAULT_WEIGHTS), rkey)
        )
        m_c = min(m_cand, enc.cfg.n_cap)
        noise = np.asarray(jax.random.uniform(rkey, (P_PAD, m_c), maxval=0.999))
        _REF_WAVE[key] = (snap_np, eb, pt, ref_snap, ref_res, noise, enc.cfg.v_cap)
    return _REF_WAVE[key]


def run_wave(name, s, m_cand=M_CAND):
    snap_np, eb, pt, ref_snap, ref_res, noise, v_cap = ref_sharded_wave(name, m_cand)
    snap, tb, ptt, w = port_inputs(snap_np, eb, pt)
    noise = torch.tensor(noise)
    single = make_wave_kernel(v_cap, m_cand, N_WAVES, 1.0, True, True, RTC, True).with_noise(
        clone(snap), tb, ptt, w, noise
    )
    mesh = vmesh(s)
    kern = make_sharded_wave_kernel(v_cap, m_cand, N_WAVES, 1.0, mesh, True, True, RTC, True)
    out = kern.with_noise(shard_snapshot(snap, mesh), tb, ptt, w, noise)
    assert_wave_equal(single, out)
    port_snap, port_res = out
    diff = tw.assert_tie_only(ref_res, port_res, eb.pod_tpl_np)
    tw.assert_snapshot_parity(
        ref_snap, gather_snapshot(port_snap), diff, ref_res, port_res,
        eb.tpl_np, eb.pod_tpl_np, eb.pod_band_np,
    )
    return ref_res, port_res


@pytest.mark.parametrize("s", MESHES)
@pytest.mark.parametrize("name", list(tw.SCENARIOS))
def test_sharded_wave_kernel_matches_reference_and_single_device(name, s):
    ref_res, port_res = run_wave(name, s)
    if name == "anti_affinity":
        assert int(port_res.placed.sum()) == 3
    if name == "pinned":
        assert int(port_res.chosen[0]) == 1 and not bool(port_res.placed[2])


@pytest.mark.parametrize("s", [4, 8])
def test_sharded_wave_kernel_with_m_cand_larger_than_a_shard(s):
    """m_cand 64 over 128 rows: 32 or 16 rows a shard, each shard gives all
    of them to the merge, and m_c stays min(m_cand, N) = 64."""
    run_wave("graft_cluster", s, m_cand=64)


_REF_SERIAL = {}


def serial_inputs(name):
    """(enc inputs, the reference's sharded serial result) per scenario."""
    if name not in _REF_SERIAL:
        enc, pods = tw.SCENARIOS[name]()
        eb = ref_encode_pod_batch(enc, pods[:8], pad_to=8)
        snap = enc.flush()
        snap_np = jax.device_get(snap)
        mesh = ref_make_mesh()
        rkey = jax.random.PRNGKey(3)
        ref = jax.device_get(
            ref_sharded.make_sharded_schedule_batch(enc.cfg.v_cap, mesh)(
                ref_sharded.shard_snapshot(snap, mesh), eb.batch,
                jnp.asarray(DEFAULT_WEIGHTS), rkey,
            )
        )
        noise = reference_noise(rkey, 8, snap_np.valid.shape[0])
        _REF_SERIAL[name] = (snap_np, eb, ref, noise, enc.cfg.v_cap)
    return _REF_SERIAL[name]


@pytest.mark.parametrize("s", MESHES)
@pytest.mark.parametrize("name", list(tw.SCENARIOS))
def test_sharded_serial_kernel_matches_reference_and_single_device(name, s):
    snap_np, eb, ref, noise, v_cap = serial_inputs(name)
    snap = convert.snapshot_from_reference(snap_np, "cpu")
    batch = convert.pod_batch_from_reference(eb.batch, "cpu")
    w = convert.weights_from_reference(DEFAULT_WEIGHTS, "cpu")
    noise = torch.tensor(noise)
    single = make_schedule_batch(v_cap)(snap, batch, w, noise)
    mesh = vmesh(s)
    out = make_sharded_schedule_batch(v_cap, mesh)(shard_snapshot(snap, mesh), batch, w, noise)
    for f in ("chosen", "score", "feasible_count"):
        a, b = getattr(single, f), getattr(out, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert torch.equal(single.resolvable, out.resolvable.cpu())
    diff = assert_serial_parity(ref, out)
    assert diff.size == 0, f"chosen differs from the reference at {diff}"


def pkg_objects(pkg):
    """(make_node, make_pod) of tests/test_lattice_smoke.py in package
    `pkg`'s own API objects."""
    o = importlib.import_module(f"{pkg}.api.objects")

    def node(name, cpu="4", mem="32Gi", labels=None, images=None):
        return o.Node(
            metadata=o.ObjectMeta(name=name, namespace="", labels=labels or {}),
            spec=o.NodeSpec(),
            status=o.NodeStatus(
                allocatable={"cpu": cpu, "memory": mem, "pods": 110},
                images=images or [],
            ),
        )

    def pod(name, cpu="1", mem="1Gi", labels=None, **spec_kw):
        return o.Pod(
            metadata=o.ObjectMeta(name=name, namespace="default", labels=labels or {}),
            spec=o.PodSpec(
                containers=[o.Container(requests={"cpu": cpu, "memory": mem})], **spec_kw
            ),
        )

    return o, node, pod


def sharding_cluster(pkg, enc):
    """tests/test_sharding.py's cluster fixture and _mk_pods, in package
    `pkg`'s objects."""
    o, node, pod = pkg_objects(pkg)
    sel = importlib.import_module(f"{pkg}.api.selectors").LabelSelector.make(
        match_labels={"app": "web"}
    )
    for i in range(32):
        enc.add_node(
            node(f"n{i}", labels={"zone": f"z{i % 4}", "disk": "ssd" if i % 2 else "hdd"})
        )
    for i in range(16):
        enc.add_pod(f"n{i}", pod(f"pre-{i}", labels={"app": "web"}))
    anti = o.Affinity(
        pod_anti_affinity=o.PodAntiAffinity(
            required=(o.PodAffinityTerm(label_selector=sel, topology_key="zone"),)
        )
    )
    tsc = o.TopologySpreadConstraint(
        max_skew=2, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=sel,
    )
    return [
        pod("a", labels={"app": "web"}, topology_spread_constraints=[tsc]),
        pod("b", cpu="2"),
        pod("c", labels={"app": "other"}, affinity=anti),
        pod("d", cpu="500m", node_selector={"disk": "ssd"}),
    ]


def test_sharded_kernels_through_set_sharding_match_the_reference():
    """tests/test_sharding.py's cluster: each side's encoder adopts an
    8-device mesh with set_sharding, flushes (a sharded upload) and runs
    its sharded serial and wave kernels; the port's results equal the
    reference's, the committed requested, sel_counts and prio_req too."""
    ref_enc, port_enc = RefEncoder(), SnapshotEncoder(device="cpu")
    ref_pods = sharding_cluster("kubernetes_tpu", ref_enc)
    port_pods = sharding_cluster("kubernetes_tpu_torch", port_enc)
    rmesh, pmesh = ref_make_mesh(), vmesh(8)
    key = jax.random.PRNGKey(7)

    # serial (test_sharded_matches_single_device)
    reb = ref_encode_pod_batch(ref_enc, ref_pods, pad_to=4)
    peb = encode_pod_batch(port_enc, port_pods, pad_to=4)
    ref_enc.set_sharding(ref_mesh_mod.snapshot_shardings(rmesh), ref_mesh_mod.replicated(rmesh))
    port_enc.set_sharding(snapshot_shardings(pmesh), replicated(pmesh))
    rsnap, psnap = ref_enc.flush(), port_enc.flush()
    assert isinstance(psnap, ShardedSnapshot) and psnap.n_blocks == 8
    ref = jax.device_get(
        ref_sharded.make_sharded_schedule_batch(ref_enc.cfg.v_cap, rmesh)(
            rsnap, reb.batch, jnp.asarray(DEFAULT_WEIGHTS), key
        )
    )
    port = make_sharded_schedule_batch(port_enc.cfg.v_cap, pmesh)(
        psnap, peb.batch, torch.tensor(np.asarray(DEFAULT_WEIGHTS)),
        torch.tensor(reference_noise(key, 4, psnap.n)),
    )
    assert assert_serial_parity(ref, port).size == 0

    # wave (test_sharded_wave_matches_single_device)
    reb = TemplateCache(ref_enc).encode(ref_pods, pad_to=4)
    peb = PortTemplateCache(port_enc).encode(port_pods, pad_to=4)
    rpt, _ = build_pair_table(ref_enc, reb.tpl_np, reb.num_templates)
    ppt, _ = port_build_pair_table(port_enc, peb.tpl_np, peb.num_templates)
    kern = ref_sharded.make_sharded_wave_kernel(ref_enc.cfg.v_cap, 64, 8, 1.0, rmesh)
    rsnap2, rres = jax.device_get(
        kern(ref_enc.flush(), reb.batch, rpt, np.asarray(DEFAULT_WEIGHTS), key)
    )
    noise = torch.tensor(np.asarray(jax.random.uniform(key, (4, 64), maxval=0.999)))
    psnap2, pres = make_sharded_wave_kernel(port_enc.cfg.v_cap, 64, 8, 1.0, pmesh).with_noise(
        port_enc.flush(), peb.batch, ppt, torch.tensor(np.asarray(DEFAULT_WEIGHTS)), noise
    )
    assert tw.assert_tie_only(rres, pres, reb.pod_tpl_np).size == 0
    g = gather_snapshot(psnap2)
    for f in ("requested", "sel_counts", "prio_req"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(rsnap2, f)), f)


# -- (b) the merges' boundary cases -------------------------------------------


def port_encoder(n_nodes, node_cpu, zone_of=None, pods=()):
    """A port encoder of `n_nodes` nodes (cpu per row from node_cpu(i),
    zone label from zone_of(i)) with (row, pod) placements."""
    _o, node, _pod = pkg_objects("kubernetes_tpu_torch")
    enc = SnapshotEncoder(device="cpu")
    for i in range(n_nodes):
        labels = {"zone": zone_of(i)} if zone_of else {}
        enc.add_node(node(f"n{i}", cpu=str(node_cpu(i)), labels=labels))
    for row, p in pods:
        enc.add_pod(f"n{row}", p)
    return enc


def both_wave(enc, pods, s, m_cand, seed=0):
    """The single-device and the sharded wave kernel on the encoder's
    snapshot and the same noise; asserts every output equal; returns
    (single, sharded) and the mesh."""
    cache = PortTemplateCache(enc)
    eb = cache.encode(pods, pad_to=len(pods))
    pt, _ = port_build_pair_table(enc, eb.tpl_np, eb.num_templates)
    snap = enc.flush()
    m_c = min(m_cand, snap.valid.shape[0])
    noise = torch.rand((len(pods), m_c), generator=torch.Generator().manual_seed(seed)) * 0.999
    w = torch.tensor(np.asarray(DEFAULT_WEIGHTS))
    v_cap = enc.cfg.v_cap
    single = make_wave_kernel(v_cap, m_cand, N_WAVES).with_noise(clone(snap), eb.batch, pt, w, noise)
    mesh = vmesh(s)
    out = make_sharded_wave_kernel(v_cap, m_cand, N_WAVES, 1.0, mesh).with_noise(
        shard_snapshot(snap, mesh), eb.batch, pt, w, noise
    )
    assert_wave_equal(single, out)
    return single, out, (snap, eb, pt, w, mesh)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_top_m_ties_straddling_a_shard_boundary_keep_global_row_order(s):
    """32 identical big nodes at rows i % 16 in {0, 1, 14, 15} (two each
    side of every multiple of 16, so of every shard boundary for 2, 4 and
    8 shards) tie on every score; the other 96 are small. Each shard's
    stable sort orders its ties by LOCAL row; the merged top-24 must be
    the 24 lowest GLOBAL rows of the tie, across the boundaries, exactly
    the single device's list."""
    big = {0, 1, 14, 15}
    _o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    enc = port_encoder(128, lambda i: 16 if i % 16 in big else 2)
    pods = [pod(f"p{i}", cpu="1") for i in range(4)]
    _single, _out, (snap, eb, pt, w, mesh) = both_wave(enc, pods, s, m_cand=24)
    k = make_wave_kernel(enc.cfg.v_cap, 24, N_WAVES)
    one = run_local(k._stage_a(clone(snap), eb.batch.tpl, pt, w, 24, None))
    b = snap.valid.shape[0] // s
    sts = sharded._lockstep(
        [
            k._stage_a(blk, eb.batch.tpl, pt, w, 24, i * b)
            for i, blk in enumerate(shard_snapshot(snap, mesh).blocks)
        ],
        mesh,
    )
    tied = sorted(i for i in range(128) if i % 16 in big)[:24]
    assert one["top_i"][0].tolist() == tied
    assert torch.equal(sts[0]["top_i"], one["top_i"])
    assert torch.equal(sts[0]["top_v"], one["top_v"])
    assert len({r // b for r in tied}) >= 2, "the tie must straddle a boundary"


class MergeLog:
    """Records every merge the sharded kernels ask for: (op, the shards'
    values)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = sharded._merge

        def rec(reqs, dev0):
            self.calls.append((reqs[0].op, [r.value for r in reqs]))
            return real(reqs, dev0)

        monkeypatch.setattr(sharded, "_merge", rec)

    def ops(self):
        return {op for op, _ in self.calls}


def _spanning_cluster():
    """128 nodes in two zones that alternate by row (each zone spans every
    shard), 40 pods already placed on every shard with the app=web label,
    half of them with preferred anti-affinity terms of weight 7 and 100
    (existing-pod term weights in the domain sums), and pods spreading
    over zones with required anti-affinity to app=web."""
    o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    sel = importlib.import_module("kubernetes_tpu_torch.api.selectors").LabelSelector.make(
        match_labels={"app": "web"}
    )

    def pref(wt):
        return o.Affinity(
            pod_anti_affinity=o.PodAntiAffinity(
                preferred=(
                    o.WeightedPodAffinityTerm(
                        weight=wt,
                        term=o.PodAffinityTerm(label_selector=sel, topology_key="zone"),
                    ),
                )
            )
        )

    placed = [
        (3 * i + 1, pod(f"pre-{i}", labels={"app": "web"}, affinity=pref(7 if i % 3 else 100) if i % 2 else None))
        for i in range(40)
    ]
    enc = port_encoder(128, lambda i: 8, zone_of=lambda i: f"z{i % 2}", pods=placed)
    tsc = o.TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule", label_selector=sel,
    )
    pods = [pod(f"s{i}", labels={"app": "web"}, topology_spread_constraints=[tsc]) for i in range(6)]
    pods += [pod(f"q{i}", labels={"app": "web"}, affinity=pref(7)) for i in range(2)]
    return enc, pods


@pytest.mark.parametrize("s", [2, 8])
def test_domain_sums_over_a_domain_spanning_every_shard_are_exact(s, monkeypatch):
    """Every shard holds nodes of both zones and pods counted in them, so
    every shard's partial [J, V] domain sums are nonzero in both zones;
    the sums are float32 (existing-pod term weights 7 and 100 among
    them), and because every weight is integral and every sum is under
    2**24 the merged sums equal one device's exactly — and so does every
    output (asserted by both_wave)."""
    log = MergeLog(monkeypatch)
    enc, pods = _spanning_cluster()
    both_wave(enc, pods, s, m_cand=32)
    dom_sums = [v for op, v in log.calls if op == "sum" and v[0].dim() == 2]
    assert dom_sums, "no domain-sum merge ran"
    partials = dom_sums[0]
    assert len(partials) == s
    for part in partials:
        assert part.dtype == torch.float32
        assert (part.sum(dim=0) > 0).sum() >= 2, "a shard without both zones' counts"
        assert torch.equal(part, part.round())
    eterm = [v for op, v in log.calls if op == "sum" and v[0].dim() == 2]
    assert all(torch.equal(p, p.round()) for v in eterm for p in v)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_best_node_on_the_last_shard(s):
    """Only the last row (127, on the last shard at every mesh size) can
    hold the 6-cpu pod: both sharded kernels choose it, with a feasible
    count of 1, as one device does."""
    _o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    enc = port_encoder(128, lambda i: 8 if i == 127 else 2)
    pods = [pod("big", cpu="6"), pod("small", cpu="1")]
    (_s1, r1), _out, (snap, _eb, _pt, w, mesh) = both_wave(enc, pods, s, m_cand=16)
    assert int(r1.chosen[0]) == 127 and int(r1.feasible_count[0]) == 1
    batch = encode_pod_batch(enc, pods, pad_to=2).batch
    noise = torch.rand((2, 128), generator=torch.Generator().manual_seed(5))
    one = make_schedule_batch(enc.cfg.v_cap)(snap, batch, w, noise)
    out = make_sharded_schedule_batch(enc.cfg.v_cap, mesh)(shard_snapshot(snap, mesh), batch, w, noise)
    assert int(out.chosen[0]) == 127 and torch.equal(out.chosen, one.chosen)
    assert torch.equal(out.feasible_count, one.feasible_count)


def test_every_merge_runs_across_the_shards(monkeypatch):
    """The counterpart of the reference's test_sharded_collectives_in_hlo:
    the sharded kernels really merge across the shards — every kind of
    merge each kernel needs runs, each over all 8 shards' partials — and
    never compute on one shard alone."""
    log = MergeLog(monkeypatch)
    enc, pods = _spanning_cluster()
    both_wave(enc, pods, 8, m_cand=32)
    assert log.ops() == {"sum", "any", "max", "top"}
    assert all(len(v) == 8 for _op, v in log.calls)
    log.calls.clear()
    snap = enc.flush()
    batch = encode_pod_batch(enc, pods, pad_to=8).batch
    mesh = vmesh(8)
    noise = torch.rand((8, 128), generator=torch.Generator().manual_seed(1))
    w = torch.tensor(np.asarray(DEFAULT_WEIGHTS))
    out = make_sharded_schedule_batch(enc.cfg.v_cap, mesh)(shard_snapshot(snap, mesh), batch, w, noise)
    assert log.ops() == {"sum", "max", "argmax"}
    assert all(len(v) == 8 for _op, v in log.calls)
    one = make_schedule_batch(enc.cfg.v_cap)(snap, batch, w, noise)
    assert torch.equal(out.chosen, one.chosen) and torch.equal(out.score, one.score)


# -- (c) the sharded snapshot in the encoder ----------------------------------


def encoder_pair(s=8):
    """Two encoders over the same cluster (SchedulingPodAffinity's 48 nodes
    and 40 pods, as tests/test_torch_device_defense.py's pair): one on one
    device, one sharded over an s-entry mesh."""
    from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload

    out = []
    for sharded_ in (False, True):
        enc = SnapshotEncoder(device="cpu")
        nodes, init, _ = build_workload(WorkloadConfig("SchedulingPodAffinity", 48, 40, 1))
        for n in nodes:
            enc.add_node(n)
        for i, p in enumerate(init):
            enc.add_pod(f"node-{(5 * i) % 48}", p)
        if sharded_:
            mesh = vmesh(s)
            enc.set_sharding(snapshot_shardings(mesh), replicated(mesh))
        enc.flush()
        out.append(enc)
    return out


def test_set_sharding_uploads_one_row_block_per_entry():
    one, enc = encoder_pair(8)
    snap = enc.flush()
    assert isinstance(snap, ShardedSnapshot) and enc.mesh.size == 8
    assert snap.n == enc.cfg.n_cap and snap.rows == enc.cfg.n_cap // 8
    ptrs = set()
    masters = enc._masters()
    for s, blk in enumerate(snap.blocks):
        for name in DeviceSnapshot._fields:
            t, m = getattr(blk, name), getattr(masters, name)
            assert t._base is None and t.is_contiguous(), name  # its own allocation
            assert t.data_ptr() % 16 == 0 and t.data_ptr() not in ptrs, name
            ptrs.add(t.data_ptr())
            if name in ("eterm_topo_key", "eterm_kind", "band_prio"):
                np.testing.assert_array_equal(t.numpy(), m, err_msg=name)
            else:
                np.testing.assert_array_equal(
                    t.numpy(), m[s * snap.rows:(s + 1) * snap.rows], err_msg=name
                )
    g, want = gather_snapshot(snap), one.flush()
    for name in DeviceSnapshot._fields:
        assert torch.equal(getattr(g, name), getattr(want, name)), name
    # back to one device
    enc.set_sharding(None, None)
    assert enc.mesh is None and isinstance(enc.flush(), DeviceSnapshot)


@pytest.mark.parametrize("donate", [True, False])
def test_sharded_scatter_routes_dirty_rows_to_their_owning_blocks(donate):
    """Pods added on nodes at rows 3 (block 0 of 8) and 37 (block 2: rows
    32-47) change exactly those rows, in their owning blocks at local rows
    3 and 5; every other block's rows stay as they were (and with donate
    False the live blocks are not touched at all); the assembled snapshot
    equals the single-device encoder's after the same updates."""
    one, enc = encoder_pair(8)
    before = enc.flush()
    old = [blk.requested.clone() for blk in before.blocks]
    _o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    for e in (one, enc):
        e.add_pod("node-3", pod("x0", cpu="1"))
        e.add_pod("node-37", pod("x1", cpu="2"))
    after = enc.flush(donate=donate)
    b = after.rows
    rows = (enc.row_of("node-3"), enc.row_of("node-37"))
    assert rows == (3, 37)
    for s, blk in enumerate(after.blocks):
        changed = (blk.requested != old[s]).any(dim=1).nonzero().flatten().tolist()
        want = [r - s * b for r in rows if r // b == s]
        assert changed == want, (s, changed, want)
    if not donate:  # alias-free: the live blocks were not touched
        assert all(torch.equal(blk.requested, o) for blk, o in zip(before.blocks, old))
    g, want = gather_snapshot(after), one.flush()
    for name in DeviceSnapshot._fields:
        assert torch.equal(getattr(g, name), getattr(want, name)), name


def test_copy_on_pin_clones_every_block_and_a_retire_frees_every_block():
    metrics.reset()
    _one, enc = encoder_pair(4)
    lease = enc.pin_generation().__enter__()
    pinned = lease.snap
    refs = [weakref.ref(blk.requested) for blk in pinned.blocks]
    kept = [blk.requested.clone() for blk in pinned.blocks]
    enc.mark_row_dirty("node-1")
    _o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    enc.add_pod("node-40", pod("y", cpu="1"))
    new = enc.flush(donate=True)
    assert metrics.counter("snapshot_generation_copy_on_pin_total") == 1
    for a, b, k in zip(pinned.blocks, new.blocks, kept):
        for name in DeviceSnapshot._fields:
            assert getattr(a, name).data_ptr() != getattr(b, name).data_ptr(), name
        assert torch.equal(a.requested, k)  # the pinned blocks are intact
    owner = enc.row_of("node-40") // new.rows
    assert not torch.equal(new.blocks[owner].requested, kept[owner])
    del pinned, a, b
    lease.__exit__(None, None, None)
    gc.collect()
    assert all(r() is None for r in refs), "a retired generation kept a block"
    assert metrics.gauge("snapshot_generation_retiring") == 0.0


def test_stall_watchdog_counts_a_sharded_generation_once():
    from kubernetes_tpu_torch.ops.encoding import RETIRE_STALL_AFTER_S

    metrics.reset()
    _one, enc = encoder_pair(8)
    leaked = enc.pin_generation().__enter__()
    enc.mark_row_dirty("node-0")
    enc.flush(donate=True)
    enc._retiring[0].superseded_at -= RETIRE_STALL_AFTER_S + 1.0
    enc.check_retire_stalls()
    assert metrics.counter("snapshot_generation_retire_stalls_total") == 1
    leaked.__exit__(None, None, None)


READERS = ["fetch_device_rows", "whatif_overlay", "preempt_select", "preempt_whatif", "corrupt_device_rows"]


@pytest.mark.parametrize("reader", READERS)
def test_readers_answer_on_a_sharded_snapshot_as_on_one_device(reader):
    """The readers that take a sharded snapshot through gather_snapshot
    (the rows they need, assembled on the first device) answer exactly as
    on the single-device snapshot of the same cluster."""
    one, enc = encoder_pair(8)
    if reader == "fetch_device_rows":
        rows = [0, 37, 100, 5, 37]
        a, b = one.fetch_device_rows(rows), enc.fetch_device_rows(rows)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    if reader == "corrupt_device_rows":
        from kubernetes_tpu_torch.testing.device_faults import corrupt_device_rows

        for e in (one, enc):
            corrupt_device_rows(e, [2, 50, 90])
        assert isinstance(enc._device, ShardedSnapshot)
        a, b = one._device, gather_snapshot(enc._device)
        for name in DeviceSnapshot._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        return
    if reader == "whatif_overlay":
        _o, node, _pod = pkg_objects("kubernetes_tpu_torch")
        virt = [node(f"v{i}", cpu="16", labels={"zone": "zv"}) for i in range(3)]
        (a, ra), (b, rb) = one.whatif_overlay(virt, [3, 40]), enc.whatif_overlay(virt, [3, 40])
        assert ra == rb and isinstance(b, DeviceSnapshot)
        for name in DeviceSnapshot._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        return
    _o, _node, pod = pkg_objects("kubernetes_tpu_torch")
    pods = [pod(f"w{i}", cpu=str(1 + i % 3)) for i in range(4)]
    ba, bb = encode_pod_batch(one, pods, pad_to=4).batch, encode_pod_batch(enc, pods, pad_to=4).batch
    prios = torch.tensor([100, 50, 0, 1000], dtype=torch.int32)
    sa, sb = one.flush(), gather_snapshot(enc.flush())
    if reader == "preempt_whatif":
        assert torch.equal(preempt_whatif(sa, ba, prios), preempt_whatif(sb, bb, prios))
        return
    ra, rb = preempt_select(sa, ba, prios), preempt_select(sb, bb, prios)
    for f in ra._fields:
        assert torch.equal(getattr(ra, f), getattr(rb, f)), f


# -- (d) the Scheduler on a mesh ----------------------------------------------


@pytest.mark.parametrize("use_wave", [True, False], ids=["wave", "serial"])
def test_scheduler_adopts_an_8_entry_mesh_and_binds(use_wave):
    """The counterpart of test_scheduler_uses_mesh_end_to_end: with the
    reference's default configuration (use_mesh on) and eight virtual CPU
    entries, _bringup adopts the mesh, the snapshot is sharded, and every
    pod binds through the sharded kernels."""
    import time

    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler

    metrics.reset()
    _o, node, pod = pkg_objects("kubernetes_tpu_torch")
    server = APIServer()
    for i in range(16):
        server.create("nodes", node(f"n{i}", cpu="8", labels={"zone": f"z{i % 4}"}))
    sched = Scheduler(
        server, KubeSchedulerConfiguration(use_wave=use_wave, antientropy_period_s=0.1),
        device="cpu", mesh_devices=virtual_devices("cpu", 8),
    )
    sched.start()
    try:
        assert sched._mesh is not None and sched._mesh.size == 8
        assert metrics.gauge("scheduler_mesh_devices") == 8.0
        for i in range(24):
            server.create("pods", pod(f"p{i}", cpu="500m"))
        deadline = time.time() + 60
        while time.time() < deadline:
            pods, _ = server.list("pods")
            if pods and all(p.spec.node_name for p in pods):
                break
            time.sleep(0.05)
        pods, _ = server.list("pods")
        assert all(p.spec.node_name for p in pods)
        assert isinstance(sched.cache.encoder._device, ShardedSnapshot)
        assert metrics.counter("snapshot_drift_rows_total") == 0
    finally:
        sched.stop()


def test_no_mesh_without_more_than_one_entry():
    """A mesh is adopted only with use_mesh and more than one entry; with
    no mesh_devices on the CPU there is none (one card: the same)."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler

    for kw, cfg in (
        ({}, KubeSchedulerConfiguration()),
        ({"mesh_devices": virtual_devices("cpu", 1)}, KubeSchedulerConfiguration()),
        ({"mesh_devices": virtual_devices("cpu", 8)}, KubeSchedulerConfiguration(use_mesh=False)),
    ):
        s = Scheduler(APIServer(), cfg, device="cpu", **kw)
        try:
            s._bringup()
            assert s._mesh is None and s.cache.encoder.mesh is None
        finally:
            s.stop()


PARITY = ["SchedulingPodAffinity", "SchedulingPodAntiAffinity", "SchedulingBasic",
          "TopologySpreading", "SchedulingPreferredPodAffinity", "SchedulingNodeAffinity"]


@pytest.mark.parametrize("name", PARITY)
def test_scheduler_on_a_mesh_matches_reference_batch_by_batch(name, monkeypatch):
    """tests/test_torch_scheduler.py's batch parity (batch 16, m_cand 16)
    with use_mesh on both sides: the reference's Scheduler shards over
    its 8 virtual devices, the port's over virtual_devices("cpu", 8); per
    batch the popped pods, the kernel variants, every kernel result, the
    placed, deferred and bound sets and the bindings are equal."""
    import test_torch_scheduler as tts

    ref, port = tts.batch_parity(
        name, 16, 16, monkeypatch, mesh_devices=virtual_devices("cpu", 8), use_mesh=True,
    )
    assert ref._mesh is not None and port._mesh is not None and port._mesh.size == 8


@pytest.mark.parametrize("name", ["SchedulingPodAffinity", "SchedulingPodAntiAffinity", "TopologySpreading"])
def test_serial_scheduler_on_a_mesh_matches_reference_batch_by_batch(name):
    """The serial batch parity with use_mesh on both sides: every sharded
    serial kernel result equals the reference's (chosen exactly)."""
    import test_torch_scheduler as tts

    ref, port = tts.serial_parity(name, mesh_devices=virtual_devices("cpu", 8), use_mesh=True)
    assert ref._mesh is not None and port._mesh is not None and port._mesh.size == 8


def test_standby_on_a_mesh_warms_the_sharded_kernels_and_promotes():
    """start_standby on an 8-entry mesh: the warm-up launches the sharded
    wave and serial kernels once (the unsatisfiable ghost pod placed
    nowhere), promote() binds the pods queued meanwhile."""
    import time

    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration, Scheduler

    metrics.reset()
    _o, node, pod = pkg_objects("kubernetes_tpu_torch")
    server = APIServer()
    for i in range(8):
        server.create("nodes", node(f"n{i}", cpu="8"))
    sched = Scheduler(
        server, KubeSchedulerConfiguration(antientropy_period_s=0), device="cpu",
        mesh_devices=virtual_devices("cpu", 8),
    )
    try:
        sched.start_standby(identity="b")
        assert sched._mesh is not None
        assert metrics.counter("scheduler_ha_standby_warmups_total") == 1
        assert isinstance(sched.cache.encoder._device, ShardedSnapshot)
        for i in range(12):
            server.create("pods", pod(f"p{i}", cpu="500m"))
        sched.promote()
        deadline = time.time() + 60
        while time.time() < deadline and not all(
            p.spec.node_name for p in server.list("pods")[0]
        ):
            time.sleep(0.05)
        assert all(p.spec.node_name for p in server.list("pods")[0])
    finally:
        sched.stop()
