"""Encoding parity: the same node and pod sequence goes into the reference
(kubernetes_tpu) and the port (kubernetes_tpu_torch, on the CPU), and every
field of DeviceSnapshot, PodBatch, TemplateBatch and PairTable must equal
the reference's ``np.asarray`` — values, shape and dtype (exact: these are
integer, boolean and integer-valued float tensors built from the same host
masters).

Covered: the __graft_entry__._build_cluster shape (zones, taints, labels,
prefilled pods with selectors) widened with host ports, images, preferred
node affinity, avoid annotations and priorities; SchedulingPodAffinity at
64 nodes; pod and node removal; the dirty-row scatter, copy-on-pin and
capacity-growth (``_grow``) flush paths.

``build_cluster`` and the comparison helpers are shared by the other
tests/test_torch_*.py files.
"""

import importlib

import numpy as np
import torch

from kubernetes_tpu.ops.batch import encode_pod_batch as ref_encode_pod_batch
from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.templates import TemplateCache as RefTemplateCache
from kubernetes_tpu.ops.templates import build_pair_table as ref_build_pair_table
from kubernetes_tpu.perf.workloads import WorkloadConfig as RefWorkloadConfig
from kubernetes_tpu.perf.workloads import build_workload as ref_build_workload
from kubernetes_tpu_torch.ops.batch import encode_pod_batch
from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
from kubernetes_tpu_torch.ops.templates import TemplateCache, build_pair_table
from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


def build_cluster(pkg: str, num_nodes: int = 24, num_prefill: int = 16, num_pending: int = 16):
    """(nodes, [(node_name, pod)], pending) in package `pkg`'s own API
    objects: the _build_cluster shape of __graft_entry__.py plus host
    ports, images, preferred node affinity, avoid annotations, owner
    references and priorities."""
    o = importlib.import_module(f"{pkg}.api.objects")
    LabelSelector = importlib.import_module(f"{pkg}.api.selectors").LabelSelector
    nodes = []
    for i in range(num_nodes):
        taints = []
        if i % 8 == 0:
            taints.append(o.Taint("dedicated", "infra", "NoSchedule"))
        if i % 11 == 3:
            taints.append(o.Taint("flaky", "yes", "PreferNoSchedule"))
        ann = {}
        if i % 6 == 1:
            ann["scheduler.alpha.kubernetes.io/preferAvoidPods"] = "ReplicaSet/web-rs"
        nodes.append(
            o.Node(
                metadata=o.ObjectMeta(
                    name=f"node-{i}",
                    namespace="",
                    labels={
                        "zone": f"z{i % 4}",
                        "disk": "ssd" if i % 2 else "hdd",
                        "rack": f"r{i % 3}",
                        "gen": str(i % 5),
                    },
                    annotations=ann,
                ),
                spec=o.NodeSpec(taints=taints, unschedulable=(i == num_nodes - 1)),
                status=o.NodeStatus(
                    allocatable={"cpu": "8", "memory": "32Gi", "pods": 110},
                    images=(
                        [o.ContainerImage(names=["img/web:1"], size_bytes=300 * 2**20)]
                        if i % 3 == 0
                        else []
                    ),
                ),
            )
        )
    sel = LabelSelector.make(match_labels={"app": "web"})
    prefill = []
    for i in range(num_prefill):
        kw = {}
        if i % 4 == 1:
            kw["affinity"] = o.Affinity(
                pod_anti_affinity=o.PodAntiAffinity(
                    required=(
                        o.PodAffinityTerm(
                            label_selector=LabelSelector.make(match_labels={"app": "db"}),
                            topology_key="zone",
                        ),
                    )
                )
            )
        if i % 5 == 2:
            kw["affinity"] = o.Affinity(
                pod_affinity=o.PodAffinity(
                    preferred=(
                        o.WeightedPodAffinityTerm(
                            7, o.PodAffinityTerm(label_selector=sel, topology_key="rack")
                        ),
                    )
                )
            )
        prefill.append(
            (
                f"node-{i % num_nodes}",
                o.Pod(
                    metadata=o.ObjectMeta(
                        name=f"pre-{i}", labels={"app": "web" if i % 3 else "db"}
                    ),
                    spec=o.PodSpec(
                        containers=[
                            o.Container(
                                requests={"cpu": "500m", "memory": "512Mi"},
                                ports=(
                                    [o.ContainerPort(container_port=80, host_port=8080)]
                                    if i % 7 == 0
                                    else []
                                ),
                            )
                        ],
                        priority=(0, 10, 100)[i % 3],
                        **kw,
                    ),
                ),
            )
        )

    def pending(i: int):
        spec_kw = {}
        if i % 3 == 0:
            spec_kw["topology_spread_constraints"] = [
                o.TopologySpreadConstraint(
                    max_skew=2,
                    topology_key="zone",
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=sel,
                )
            ]
        if i % 3 == 1:
            spec_kw["affinity"] = o.Affinity(
                pod_anti_affinity=o.PodAntiAffinity(
                    required=(
                        o.PodAffinityTerm(
                            label_selector=sel, topology_key="kubernetes.io/hostname"
                        ),
                    )
                )
            )
        if i % 4 == 2:
            spec_kw["affinity"] = o.Affinity(
                node_affinity=o.NodeAffinity(
                    preferred=(
                        o.PreferredSchedulingTerm(
                            5,
                            o.NodeSelectorTerm(
                                match_expressions=(
                                    o.NodeSelectorRequirement("gen", "Gt", ("2",)),
                                )
                            ),
                        ),
                    )
                )
            )
        if i % 5 == 0:
            spec_kw["node_selector"] = {"disk": "ssd"}
        if i % 7 == 0:
            spec_kw["tolerations"] = [o.Toleration(key="dedicated", operator="Exists")]
        meta = o.ObjectMeta(name=f"pending-{i}", labels={"app": "web"})
        if i % 6 == 5:
            meta.owner_references = [
                o.OwnerReference(kind="ReplicaSet", name="web-rs", controller=True)
            ]
        return o.Pod(
            metadata=meta,
            spec=o.PodSpec(
                containers=[
                    o.Container(
                        image="img/web:1" if i % 2 else "",
                        requests={"cpu": "250m", "memory": "256Mi"},
                        ports=(
                            [o.ContainerPort(container_port=80, host_port=8080)]
                            if i % 8 == 3
                            else []
                        ),
                    )
                ],
                priority=(0, 100)[i % 2],
                **spec_kw,
            ),
        )

    return nodes, prefill, [pending(i) for i in range(num_pending)]


def port_encoder(cfg=None):
    """A port encoder on the CPU whose config equals the reference's."""
    return SnapshotEncoder(
        None if cfg is None else EncodingConfig(**cfg.__dict__), device="cpu"
    )


def feed(enc, nodes, prefill):
    for n in nodes:
        enc.add_node(n)
    for node_name, pod in prefill:
        enc.add_pod(node_name, pod)


def to_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_fields(ref, port, what="", fields=None):
    """Every field of the port's NamedTuple equals the reference's (values,
    shape and dtype); nested NamedTuples recurse."""
    assert type(port)._fields == type(ref)._fields, what
    for f in fields or ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if hasattr(a, "_fields"):
            assert_same_fields(a, b, f"{what}.{f}")
            continue
        a, b = np.asarray(a), to_numpy(b)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}.{f}")


def encoders_for(nodes_pairs):
    """(ref encoder, port encoder) fed the same cluster."""
    (rn, rp), (pn, pp) = nodes_pairs
    ref, port = RefEncoder(), port_encoder()
    feed(ref, rn, rp)
    feed(port, pn, pp)
    return ref, port


def _assert_batches_same(ref_enc, port_enc, ref_pods, port_pods, pad):
    ref_eb = ref_encode_pod_batch(ref_enc, ref_pods, pad_to=pad)
    port_eb = encode_pod_batch(port_enc, port_pods, pad_to=pad)
    assert_same_fields(ref_eb.batch, port_eb.batch, "PodBatch")
    assert_same_fields(ref_eb.batch_np, port_eb.batch_np, "PodBatch_np")
    np.testing.assert_array_equal(port_eb.fallback, ref_eb.fallback)
    ref_tc, port_tc = RefTemplateCache(ref_enc), TemplateCache(port_enc)
    ref_tb = ref_tc.encode(ref_pods, pad_to=pad)
    port_tb = port_tc.encode(port_pods, pad_to=pad)
    assert port_tb.num_templates == ref_tb.num_templates
    assert_same_fields(ref_tb.batch, port_tb.batch, "TemplateBatch")
    np.testing.assert_array_equal(port_tb.fallback, ref_tb.fallback)
    ref_pt, ref_over = ref_build_pair_table(ref_enc, ref_tb.tpl_np, ref_tb.num_templates)
    port_pt, port_over = build_pair_table(port_enc, port_tb.tpl_np, port_tb.num_templates)
    assert port_over == ref_over
    assert_same_fields(ref_pt, port_pt, "PairTable")
    for t in (port_eb.batch, port_tb.batch.tpl, port_pt):
        assert all(x.device.type == "cpu" for x in t)


def _assert_flush_same(ref_enc, port_enc):
    ref_snap = ref_enc.flush()
    port_snap = port_enc.flush()
    assert_same_fields(ref_snap, port_snap, "DeviceSnapshot")
    return ref_snap, port_snap


def test_graft_cluster_encoding_matches_reference():
    ref_enc, port_enc = encoders_for([build_cluster(p)[:2] for p in PACKAGES])
    _, _, ref_pending = build_cluster("kubernetes_tpu")
    _, _, port_pending = build_cluster("kubernetes_tpu_torch")
    # batch encoding first: it interns predicates and back-fills counts
    _assert_batches_same(ref_enc, port_enc, ref_pending, port_pending, pad=16)
    _assert_flush_same(ref_enc, port_enc)
    assert port_enc.cfg == type(port_enc.cfg)(**ref_enc.cfg.__dict__)


def test_churn_scatter_copy_on_pin_and_growth_match_reference():
    """Removals and adds (dirty-row scatter), a flush under a reader pin
    (copy-on-pin: the pinned generation must stay untouched), and label
    and predicate vocabularies growing past k_cap / s_cap (``_grow`` and
    the reshape upload)."""
    ref_enc, port_enc = encoders_for([build_cluster(p)[:2] for p in PACKAGES])
    _assert_flush_same(ref_enc, port_enc)

    # -- churn: a pod leaves, a node leaves, new pods land (dirty rows) --
    for enc in (ref_enc, port_enc):
        enc.remove_pod("node-3", "default/pre-3")
        enc.remove_node("node-5")
    extra = {p: build_cluster(p, num_prefill=24)[1][16:] for p in PACKAGES}
    for (nm, rp), (_, pp) in zip(extra["kubernetes_tpu"], extra["kubernetes_tpu_torch"]):
        if nm != "node-5":
            ref_enc.add_pod(nm, rp)
            port_enc.add_pod(nm, pp)
    with port_enc.pin_generation() as lease:
        pinned = [t.clone() for t in lease.snap]
        _assert_flush_same(ref_enc, port_enc)
        for before, now in zip(pinned, lease.snap):
            assert torch.equal(before, now), "copy-on-pin let a donor write a pinned tensor"
    _assert_flush_same(ref_enc, port_enc)

    # -- growth: 40 new label keys (k_cap 32) and 12 new predicates (s_cap 8) --
    for pkg, enc in zip(PACKAGES, (ref_enc, port_enc)):
        o = importlib.import_module(f"{pkg}.api.objects")
        LabelSelector = importlib.import_module(f"{pkg}.api.selectors").LabelSelector
        enc.add_node(
            o.Node(
                metadata=o.ObjectMeta(
                    name="wide", namespace="", labels={f"k{i}": f"v{i}" for i in range(40)}
                ),
                spec=o.NodeSpec(),
                status=o.NodeStatus(allocatable={"cpu": "4", "memory": "8Gi", "pods": 20}),
            )
        )
        for i in range(12):
            enc.intern_predicate(
                frozenset({"default"}), LabelSelector.make(match_labels={"app": f"a{i}"})
            )
    assert port_enc.cfg.k_cap > 32 and port_enc.cfg.s_cap > 8
    _assert_flush_same(ref_enc, port_enc)
    _, _, ref_pending = build_cluster("kubernetes_tpu")
    _, _, port_pending = build_cluster("kubernetes_tpu_torch")
    _assert_batches_same(ref_enc, port_enc, ref_pending, port_pending, pad=32)
    _assert_flush_same(ref_enc, port_enc)


def test_pod_affinity_workload_encoding_matches_reference():
    ref_nodes, ref_init, ref_fac = ref_build_workload(
        RefWorkloadConfig("SchedulingPodAffinity", 64, 16, 32)
    )
    port_nodes, port_init, port_fac = build_workload(
        WorkloadConfig("SchedulingPodAffinity", 64, 16, 32)
    )
    ref_enc = RefEncoder(type(RefEncoder().cfg).for_cluster(64))
    port_enc = port_encoder(ref_enc.cfg)
    feed(ref_enc, ref_nodes, [(f"node-{(7 * i) % 64}", p) for i, p in enumerate(ref_init)])
    feed(port_enc, port_nodes, [(f"node-{(7 * i) % 64}", p) for i, p in enumerate(port_init)])
    _assert_batches_same(
        ref_enc, port_enc, [ref_fac(i) for i in range(32)], [port_fac(i) for i in range(32)], pad=32
    )
    _assert_flush_same(ref_enc, port_enc)
