"""The slice end to end: the port's wave path
(kubernetes_tpu_torch/scheduler/wavepath.py) over several batches of
SchedulingPodAffinity and SchedulingPodAntiAffinity at 64 nodes, on the
CPU, against the reference's own pieces of the same path (TemplateCache,
build_pair_table, Scheduler._batch_waves, the jitted wave kernel inside
the encoder's donation lease, add_pod(device_synced=True)).

Per batch: the batch's wave count and hard-pair flag are equal, the kernel
results agree under the tie rule of test_torch_wavelattice (exact masks,
counts and snapshot; float scores within rtol = atol = 1e-5; chosen equal
except near-ties within TIE_EPS) on the same tie noise, and the live
device snapshots after the commit are equal. After each batch BOTH sides
commit the REFERENCE's placements (the port re-uploads when a tie made it
differ), so one tie cannot cascade into later batches.

Then a port-only run (tie noise from a torch.Generator) must place every
pod, keep requested <= allocatable, and every placement must pass the
reference's host filter chain (the _oracle_framework route of
tests/test_fuzz_differential.py) against the cluster holding every other
pod placed up to the end of its batch.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.encoding import EncodingConfig as RefEncodingConfig
from kubernetes_tpu.ops.encoding import SnapshotEncoder as RefEncoder
from kubernetes_tpu.ops.templates import TemplateCache as RefTemplateCache
from kubernetes_tpu.ops.templates import build_pair_table as ref_build_pair_table
from kubernetes_tpu.ops.wavelattice import DEFAULT_RTC_SHAPE, make_wave_kernel_jit
from kubernetes_tpu.perf.workloads import WorkloadConfig as RefWorkloadConfig
from kubernetes_tpu.perf.workloads import build_workload as ref_build_workload
from kubernetes_tpu.scheduler.cache.nodeinfo import Snapshot
from kubernetes_tpu.scheduler.framework.interface import CycleState, is_success
from kubernetes_tpu.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.ops.lattice import weights_for_policy
from kubernetes_tpu_torch.ops.templates import TemplateCache
from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload
from kubernetes_tpu_torch.scheduler.wavepath import (
    WavePathConfig,
    commit_batch,
    finish_batch,
    launch_wave_kernel,
    prepare_batch,
    schedule_pods,
)

from test_fuzz_differential import _oracle_framework
from test_torch_encoding import assert_same_fields, feed, port_encoder
from test_torch_wavelattice import assert_snapshot_parity, assert_tie_only

N_NODES = 64
CFG = WavePathConfig(batch_size=16, m_cand=16, n_waves=16)
WORKLOADS = {
    "SchedulingPodAffinity": (16, 48),
    "SchedulingPodAntiAffinity": (8, 48),
}


def _init_node(i: int) -> str:
    return f"node-{(7 * i) % N_NODES}"


def _build(name):
    n_init, n_measured = WORKLOADS[name]
    ref_nodes, ref_init, ref_fac = ref_build_workload(
        RefWorkloadConfig(name, N_NODES, n_init, n_measured)
    )
    port_nodes, port_init, port_fac = build_workload(
        WorkloadConfig(name, N_NODES, n_init, n_measured)
    )
    ref_enc = RefEncoder(RefEncodingConfig.for_cluster(N_NODES))
    port_enc = port_encoder(ref_enc.cfg)
    feed(ref_enc, ref_nodes, [(_init_node(i), p) for i, p in enumerate(ref_init)])
    feed(port_enc, port_nodes, [(_init_node(i), p) for i, p in enumerate(port_init)])
    return (
        (ref_enc, ref_nodes, ref_init, [ref_fac(i) for i in range(n_measured)]),
        (port_enc, port_nodes, port_init, [port_fac(i) for i in range(n_measured)]),
    )


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_wavepath_matches_reference_batch_by_batch(name):
    (ref_enc, _, _, ref_pods), (port_enc, _, _, port_pods) = _build(name)
    ref_tc, port_tc = RefTemplateCache(ref_enc), TemplateCache(port_enc)
    ref_sched = SimpleNamespace(
        cache=SimpleNamespace(encoder=ref_enc),
        cfg=SimpleNamespace(wave_n_waves=CFG.n_waves),
    )
    weights = weights_for_policy("default")
    port_by_name = {p.metadata.name: p for p in port_pods}
    queue = [p.metadata.name for p in ref_pods]
    ref_by_name = {p.metadata.name: p for p in ref_pods}
    batches = 0
    while queue and batches < 10:
        names, queue = queue[: CFG.batch_size], queue[CFG.batch_size:]
        batches += 1
        # -- reference: encode, waves, launch in the donation lease --
        eb = ref_tc.encode([ref_by_name[n] for n in names])
        ptab, _ = ref_build_pair_table(ref_enc, eb.tpl_np, eb.num_templates)
        n_waves, has_hard = Scheduler._batch_waves(ref_sched, eb)
        ref_enc.flush()
        kern = make_wave_kernel_jit(
            ref_enc.cfg.v_cap, CFG.m_cand, n_waves, 1.0, True, True,
            DEFAULT_RTC_SHAPE,
            bool((np.asarray(eb.batch.pod_name_row) >= 0).any()),
        )
        key = jax.random.PRNGKey(batches)
        with ref_enc.donation_lease() as dl:
            new_snap, res = kern(dl.snap, eb.batch, ptab, jnp.asarray(weights), key)
            dl.result = new_snap
        ref_res = jax.device_get(res)
        ref_snap_after = jax.device_get(ref_enc._device)

        # -- port: the same batch through prepare / launch / finish --
        prep = prepare_batch(port_enc, port_tc, [port_by_name[n] for n in names], CFG)
        assert (prep.n_waves, prep.has_hard) == (n_waves, has_hard)
        assert_same_fields(eb.batch, prep.eb.batch, "TemplateBatch")
        assert_same_fields(ptab, prep.ptab, "PairTable")
        m_c = min(CFG.m_cand, port_enc.cfg.n_cap)
        noise = torch.tensor(
            np.asarray(jax.random.uniform(key, (len(names), m_c), maxval=0.999))
        )

        def with_ref_noise(s, b, p, w, _rng, kern=prep.kern, noise=noise):
            return kern.with_noise(s, b, p, w, noise)

        port_res = launch_wave_kernel(
            port_enc, with_ref_noise, prep.eb.batch, prep.ptab,
            torch.tensor(weights), None,
        )
        diff = assert_tie_only(ref_res, port_res, eb.pod_tpl_np)
        assert_snapshot_parity(
            ref_snap_after, port_enc._device, diff, ref_res, port_res,
            eb.tpl_np, eb.pod_tpl_np, eb.pod_band_np,
        )

        # -- both commit the reference's placements --
        chosen = np.asarray(ref_res.chosen)
        placed = np.asarray(ref_res.placed)
        row_names = list(ref_enc.row_names)
        for i, n in enumerate(names):
            if placed[i]:
                ref_enc.add_pod(
                    row_names[int(chosen[i])], ref_by_name[n], device_synced=True,
                    prio_band=int(eb.pod_band_np[i]),
                )
        if len(diff) == 0:
            out = finish_batch(port_enc, prep, port_res, 0.0)
            assert [p.metadata.name for p, _ in out.placed] == [
                n for i, n in enumerate(names) if placed[i]
            ]
        else:
            commit_batch(port_enc, prep.eb, prep.row_names, chosen, placed)
            port_enc.invalidate_device()
        np.testing.assert_array_equal(port_enc.m_req, ref_enc.m_req)
        np.testing.assert_array_equal(port_enc.m_sel_counts, ref_enc.m_sel_counts)
        queue = [n for i, n in enumerate(names) if not placed[i]] + queue
    assert batches >= 3 and not queue


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_wavepath_placements_pass_reference_host_filters(name):
    (_, ref_nodes, ref_init, ref_pods), (port_enc, _, _, port_pods) = _build(name)
    result = schedule_pods(
        port_enc, TemplateCache(port_enc), port_pods,
        torch.tensor(weights_for_policy("default")),
        torch.Generator().manual_seed(11), CFG,
    )
    assert len(result.placed) == len(port_pods)
    assert not result.unscheduled and not result.fallback
    assert len(result.batches) >= 3
    assert (port_enc.m_req <= port_enc.m_alloc)[port_enc.m_valid].all()

    ref_by_name = {p.metadata.name: p for p in ref_pods}
    bound = []
    for i, pod in enumerate(ref_init):
        p = pod.deep_copy()
        p.spec.node_name = _init_node(i)
        bound.append(p)
    for bo in result.batches:
        batch = []
        for pod, node in bo.placed:
            p = ref_by_name[pod.metadata.name].deep_copy()
            p.spec.node_name = node
            batch.append(p)
        bound.extend(batch)
        for p in batch:
            others = [q for q in bound if q is not p]
            snapshot = Snapshot.from_literals(others, ref_nodes)
            fw = _oracle_framework([snapshot])
            state = CycleState()
            assert is_success(fw.run_pre_filter_plugins(state, p)), p.metadata.name
            st = fw.run_filter_plugins(state, p, snapshot.get(p.spec.node_name))
            assert is_success(st), (p.metadata.name, p.spec.node_name, st)
