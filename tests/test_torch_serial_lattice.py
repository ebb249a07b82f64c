"""Serial-kernel parity: the port's ``make_schedule_batch`` (the
``ScheduleBatch`` loop over pods, torch on the CPU) against the reference's
``make_schedule_batch`` (a ``lax.scan``, JAX on the CPU) on the
reference's OWN encoded state, carried across by ``ops/convert.py``, with
the tie noise the reference draws inside its scan
(``uniform(split(key, P)[i], (N,))`` for pod i).

Required, per case:
  * exact: feasible_count and resolvable, values and dtypes;
  * chosen equal, except where the two sides' winning scores lie within
    TIE_EPS (a near-tie the rounding may break either way); every such
    difference is asserted to be a tie, and none has occurred;
  * score within rtol = atol = 1e-5 where the chosen nodes agree.

The cases are the scenarios of tests/test_lattice_smoke.py (each of its
kernel runs, in order, on the same encoder) and the seeded random
clusters of tests/test_fuzz_differential.py's generator, as
tests/test_torch_fuzz.py runs them through the wave kernel.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.objects import (
    Affinity,
    Container,
    ContainerPort,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from kubernetes_tpu.api.selectors import LabelSelector
from kubernetes_tpu.ops.batch import encode_pod_batch
from kubernetes_tpu.ops.encoding import SnapshotEncoder
from kubernetes_tpu.ops.lattice import DEFAULT_WEIGHTS, make_schedule_batch
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.ops import lattice as port_lattice
from kubernetes_tpu_torch.ops.wavelattice import TIE_EPS

from test_fuzz_differential import _build_random_cluster, _rand_pod
from test_lattice_smoke import make_node, make_pod

RTOL = ATOL = 1e-5


def reference_noise(key, p: int, n: int) -> np.ndarray:
    """The [P, N] tie noise the reference's scan draws: pod i's
    ``jax.random.uniform`` of the i-th key of ``split(key, P)``."""
    keys = jax.random.split(key, p)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def assert_serial_parity(ref, port):
    """Returns the pods whose chosen node differs (each a near-tie)."""
    for f in ("feasible_count", "resolvable"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    ref_c, port_c = np.asarray(ref.chosen), port.chosen.numpy()
    ref_s, port_s = np.asarray(ref.score), port.score.numpy()
    assert ref_c.dtype == port_c.dtype and ref_s.dtype == port_s.dtype
    diff = np.flatnonzero(ref_c != port_c)
    for i in diff:
        assert ref_c[i] >= 0 and port_c[i] >= 0, (i, ref_c[i], port_c[i])
        assert abs(float(ref_s[i]) - float(port_s[i])) <= TIE_EPS * max(
            1.0, abs(float(ref_s[i]))
        ), (i, ref_s[i], port_s[i])
    same = ref_c == port_c
    np.testing.assert_allclose(port_s[same], ref_s[same], rtol=RTOL, atol=ATOL)
    return diff


def run_both(enc, pods, seed=0, pad_to=None, weights=DEFAULT_WEIGHTS):
    """Encode with the reference, run both kernels on that state and the
    same noise, check parity. Returns the reference's result."""
    eb = encode_pod_batch(enc, pods, pad_to=pad_to)
    snap = jax.device_get(enc.flush())
    key = jax.random.PRNGKey(seed)
    ref = jax.device_get(
        make_schedule_batch(enc.cfg.v_cap)(snap, eb.batch, jnp.asarray(weights), key)
    )
    p, n = eb.batch.valid.shape[0], snap.valid.shape[0]
    port = port_lattice.make_schedule_batch(enc.cfg.v_cap)(
        convert.snapshot_from_reference(snap, "cpu"),
        convert.pod_batch_from_reference(eb.batch, "cpu"),
        convert.weights_from_reference(weights, "cpu"),
        torch.tensor(reference_noise(key, p, n)),
    )
    diff = assert_serial_parity(ref, port)
    assert diff.size == 0, f"near-tie chosen differences at pods {diff.tolist()}"
    return ref


def _aff(kind, app, key="zone"):
    term = PodAffinityTerm(
        label_selector=LabelSelector.make(match_labels={"app": app}),
        topology_key=key,
    )
    if kind == "anti":
        return Affinity(pod_anti_affinity=PodAntiAffinity(required=(term,)))
    return Affinity(pod_affinity=PodAffinity(required=(term,)))


def _basic_fit(enc):
    for i in range(4):
        enc.add_node(make_node(f"n{i}", cpu="4"))
    enc.add_pod("n0", make_pod("existing", cpu="3"))
    return [[make_pod("p", cpu="2")]]


def _resources_infeasible(enc):
    enc.add_node(make_node("n0", cpu="2"))
    enc.add_pod("n0", make_pod("existing", cpu="1500m"))
    return [[make_pod("p", cpu="1")]]


def _in_batch_conflict(enc):
    enc.add_node(make_node("n0", cpu="3"))
    enc.add_node(make_node("n1", cpu="3"))
    return [[make_pod("a", cpu="2"), make_pod("b", cpu="2")]]


def _selector_and_affinity(enc):
    enc.add_node(make_node("gpu", labels={"accel": "gpu", "zone": "z1"}))
    enc.add_node(make_node("cpu", labels={"zone": "z2"}))
    aff = Affinity(
        node_affinity=NodeAffinity(
            required=NodeSelector(
                terms=(
                    NodeSelectorTerm(
                        match_expressions=(
                            NodeSelectorRequirement("zone", "In", ("z2",)),
                        )
                    ),
                )
            )
        )
    )
    return [
        [make_pod("p", node_selector={"accel": "gpu"})],
        [make_pod("q", affinity=aff)],
    ]


def _taints(enc):
    enc.add_node(make_node("tainted", taints=[Taint("dedicated", "db", "NoSchedule")]))
    enc.add_node(make_node("open"))
    tol = Toleration(key="dedicated", operator="Equal", value="db", effect="NoSchedule")
    return [[make_pod("p")], [make_pod("q", tolerations=[tol])]]


def _unschedulable(enc):
    enc.add_node(make_node("off", unsched=True))
    enc.add_node(make_node("on"))
    return [[make_pod("p")]]


def _pinned(enc):
    enc.add_node(make_node("n0"))
    enc.add_node(make_node("n1"))
    return [[make_pod("p", node_name="n1")]]


def _anti_affinity_existing(enc):
    enc.add_node(make_node("a1", labels={"zone": "z1"}))
    enc.add_node(make_node("b1", labels={"zone": "z2"}))
    enc.add_pod("a1", make_pod("holder", labels={"app": "db"}, affinity=_aff("anti", "web")))
    return [
        [make_pod("p", labels={"app": "web"})],
        [make_pod("q", labels={"app": "cache"})],
    ]


def _incoming_affinity(enc):
    enc.add_node(make_node("a1", labels={"zone": "z1"}))
    enc.add_node(make_node("b1", labels={"zone": "z2"}))
    enc.add_pod("a1", make_pod("web-1", labels={"app": "web"}))
    return [
        [make_pod("p", affinity=_aff("aff", "web"))],
        [make_pod("q", affinity=_aff("anti", "web"))],
    ]


def _carveout(enc):
    enc.add_node(make_node("a1", labels={"zone": "z1"}))
    aff = _aff("aff", "solo")
    return [
        [make_pod("p", labels={"app": "solo"}, affinity=aff)],
        [make_pod("q", labels={"app": "other"}, affinity=aff)],
    ]


def _spread_hard(enc):
    enc.add_node(make_node("a1", labels={"zone": "z1"}))
    enc.add_node(make_node("a2", labels={"zone": "z1"}))
    enc.add_node(make_node("b1", labels={"zone": "z2"}))
    tsc = TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector.make(match_labels={"app": "web"}),
    )
    enc.add_pod("a1", make_pod("w1", labels={"app": "web"}))
    return [[make_pod("p", labels={"app": "web"}, topology_spread_constraints=[tsc])]]


def _host_ports(enc):
    enc.add_node(make_node("n0"))
    enc.add_node(make_node("n1"))
    holder = Pod(
        metadata=ObjectMeta(name="holder"),
        spec=PodSpec(containers=[Container(ports=[ContainerPort(80, host_port=8080)])]),
    )
    enc.add_pod("n0", holder)
    contender = Pod(
        metadata=ObjectMeta(name="contender"),
        spec=PodSpec(
            containers=[
                Container(
                    requests={"cpu": "100m"},
                    ports=[ContainerPort(80, host_port=8080)],
                )
            ]
        ),
    )
    return [[contender]]


def _padding(enc):
    enc.add_node(make_node("n0"))
    return [[make_pod("p")]]


# name -> (builder returning the pod list of each kernel run, pad_to)
SCENARIOS = {
    "basic_fit": (_basic_fit, None),
    "resources_infeasible": (_resources_infeasible, None),
    "in_batch_conflict": (_in_batch_conflict, None),
    "node_selector_and_affinity": (_selector_and_affinity, None),
    "taints_and_tolerations": (_taints, None),
    "unschedulable_node": (_unschedulable, None),
    "node_name_pinned": (_pinned, None),
    "pod_anti_affinity_existing": (_anti_affinity_existing, None),
    "incoming_pod_affinity": (_incoming_affinity, None),
    "affinity_first_pod_carveout": (_carveout, None),
    "topology_spread_hard": (_spread_hard, None),
    "host_ports": (_host_ports, None),
    "batch_padding_invalid_rows": (_padding, 4),
}

# the smoke tests' own expectations, checked on the reference result so a
# scenario that stops exercising its filter fails here too
EXPECT = {
    "basic_fit": [lambda r, rn: rn(r.chosen[0]) != "n0" and r.feasible_count[0] == 3],
    "resources_infeasible": [lambda r, rn: r.chosen[0] == -1 and r.resolvable[0][0]],
    "in_batch_conflict": [lambda r, rn: {int(r.chosen[0]), int(r.chosen[1])} == {0, 1}],
    "node_selector_and_affinity": [
        lambda r, rn: rn(r.chosen[0]) == "gpu",
        lambda r, rn: rn(r.chosen[0]) == "cpu",
    ],
    "taints_and_tolerations": [
        lambda r, rn: rn(r.chosen[0]) == "open",
        lambda r, rn: r.feasible_count[0] == 2,
    ],
    "unschedulable_node": [lambda r, rn: rn(r.chosen[0]) == "on"],
    "node_name_pinned": [lambda r, rn: rn(r.chosen[0]) == "n1"],
    "pod_anti_affinity_existing": [
        lambda r, rn: rn(r.chosen[0]) == "b1",
        lambda r, rn: r.feasible_count[0] == 2,
    ],
    "incoming_pod_affinity": [
        lambda r, rn: rn(r.chosen[0]) == "a1",
        lambda r, rn: rn(r.chosen[0]) == "b1",
    ],
    "affinity_first_pod_carveout": [
        lambda r, rn: r.chosen[0] == 0,
        lambda r, rn: r.chosen[0] == -1,
    ],
    "topology_spread_hard": [lambda r, rn: rn(r.chosen[0]) == "b1"],
    "host_ports": [lambda r, rn: rn(r.chosen[0]) == "n1" and r.feasible_count[0] == 1],
    "batch_padding_invalid_rows": [
        lambda r, rn: r.chosen[0] == 0 and all(r.chosen[i] == -1 for i in range(1, 4))
    ],
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serial_kernel_matches_reference(name):
    build, pad_to = SCENARIOS[name]
    enc = SnapshotEncoder()
    runs = build(enc)
    assert len(runs) == len(EXPECT[name])
    for pods, expect in zip(runs, EXPECT[name]):
        ref = run_both(enc, pods, pad_to=pad_to)
        assert expect(ref, lambda row: enc.row_names[int(row)])


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_serial_kernel_matches_reference_on_random_clusters(seed):
    rng = random.Random(seed)
    enc, _infos, nodes = _build_random_cluster(rng, rng.randrange(8, 33))
    names = [n.metadata.name for n in nodes]
    pods = [
        _rand_pod(rng, f"p{i}", allow_pin=names)
        for i in range(rng.randrange(4, 17))
    ]
    ref = run_both(enc, pods, seed=seed, pad_to=16)
    # the batch bites: some pods placed, and the carry was exercised
    assert int((np.asarray(ref.chosen) >= 0).sum()) >= 2


def test_serial_kernel_matches_reference_with_pack_weights():
    """A non-default weight vector (the 'pack' profile: MostAllocated in
    place of LeastAllocated) matches the reference too."""
    from kubernetes_tpu.ops.lattice import WEIGHT_PROFILES

    rng = random.Random(11)
    enc, _infos, _nodes = _build_random_cluster(rng, 16)
    pods = [_rand_pod(rng, f"p{i}") for i in range(12)]
    run_both(enc, pods, seed=3, pad_to=16, weights=WEIGHT_PROFILES["pack"])
