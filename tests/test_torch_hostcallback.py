"""``host_callback_binds=True`` on the port's Scheduler (device="cpu")
against the reference's with the same setting.

The reference's wave kernel posts its fast index payload through
``io_callback`` into ``ops/hostcallback``'s ticket registry; the port's
launch hands the payload's split-phase copy to
``scheduler/wavepath.HostCallbackDelivery``, which delivers it to the
port's copy of the registry (on the CPU at once, on the card from a
thread that waits on the copy's event). The resolve takes the delivery
in both.

Batch by batch, on both parity workloads and both bucket configurations
of tests/test_torch_scheduler.py (the same batch-by-batch drive, the reference's tie
noise): the popped pods, the kernel variants, the placed, deferred and
bound sets and the bindings are equal, exactly; every launched wave
batch's payload is taken from a delivery on both sides; and both
registries' ``backlog()`` return to where they started.
"""

import pytest
import torch

from kubernetes_tpu.ops import hostcallback as ref_hostcallback
from kubernetes_tpu.utils.metrics import metrics as ref_metrics
from kubernetes_tpu_torch.ops import hostcallback
from kubernetes_tpu_torch.ops.wavelattice import WaveKernelCB, make_wave_kernel_cb
from kubernetes_tpu_torch.scheduler.wavepath import HostCallbackDelivery
from kubernetes_tpu_torch.utils.metrics import metrics

from test_torch_scheduler import WORKLOADS, batch_parity

HOSTCB = "scheduler_wave_hostcb_deliveries_total"


@pytest.mark.parametrize("batch,m_cand", [(16, 16), (512, 64)])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_host_callback_scheduler_matches_reference_batch_by_batch(
    name, batch, m_cand, monkeypatch
):
    backlog0, ref_backlog0 = hostcallback.backlog(), ref_hostcallback.backlog()
    ref_metrics.reset()
    ref, port = batch_parity(
        name, batch, m_cand, monkeypatch, host_callback_binds=True
    )
    launched = metrics.counter("scheduler_wave_batches_total")
    assert launched > 0
    assert metrics.counter(HOSTCB) == launched
    assert ref_metrics.counter(HOSTCB) == ref_metrics.counter(
        "scheduler_wave_batches_total"
    ) == launched
    assert metrics.counter("scheduler_wave_readbacks_blocking_total") == 0
    assert hostcallback.backlog() == backlog0
    assert ref_hostcallback.backlog() == ref_backlog0


def test_cb_kernel_posts_the_fast_payload_under_its_ticket():
    """make_wave_kernel_cb wraps the plain kernel: the same outputs, and
    one post of (ticket, chosen, placed, deferred) per launch."""
    kern = make_wave_kernel_cb(64, 8, 2)
    assert isinstance(kern, WaveKernelCB)
    assert kern.base.m_cand == 8 and kern.base.n_waves == 2
    posted = []

    class _Base:
        def with_noise(self, snap, tb, pt, weights, noise):
            res = type("R", (), {})()
            res.chosen, res.placed, res.deferred = (
                torch.tensor([1]), torch.tensor([True]), torch.tensor([False])
            )
            return "snap", res

    kern.base = _Base()
    snap, res = kern.with_noise(
        None, None, None, None, None, 7, lambda *a: posted.append(a)
    )
    assert snap == "snap" and len(posted) == 1
    assert posted[0][0] == 7 and posted[0][1] is res.chosen


def test_delivery_on_the_cpu_lands_at_once_and_drops_discarded_tickets():
    d = HostCallbackDelivery()
    t = hostcallback.new_ticket()
    chosen, placed, deferred = (
        torch.tensor([3, -1]), torch.tensor([True, False]),
        torch.tensor([False, True]),
    )
    copy = d.post(t, chosen, placed, deferred)
    assert copy.ready() and hostcallback.ready(t)
    got = hostcallback.take(t, timeout=0.0)
    assert [a.tolist() for a in got] == [[3, -1], [True, False], [False, True]]
    t2 = hostcallback.new_ticket()
    hostcallback.discard(t2)
    d.post(t2, chosen, placed, deferred)
    assert not hostcallback.ready(t2) and hostcallback.take(t2) is None
    d.close()
