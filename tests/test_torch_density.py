"""tests/test_density.py on the port: the CI throughput floor the
reference enforces (test/integration/scheduler_perf/scheduler_test.go:
40-42: fail below 30 pods/s, warn below 100 on the 3k-pod/100-node
density config), through the port's run_benchmark on the CPU
(device="cpu"), with the reference test's inputs and assertions: every
pod bound and at least 30 pods/s. On the CPU the floor guards the host
path (queue, encode, store); the card's speed is chip_smoke.py's."""

import logging

import pytest

from kubernetes_tpu_torch.perf.harness import run_benchmark
from kubernetes_tpu_torch.perf.workloads import WORKLOADS, WorkloadConfig

logger = logging.getLogger(__name__)

THRESHOLD = 30.0  # hard floor (scheduler_test.go threshold3K)
WARNING = 100.0


@pytest.mark.parametrize(
    "nodes,pods,timeout_s",
    [(100, 3000, 240), (1000, 3000, 300)],
    ids=["100n-3k", "1000n-3k"],
)
def test_density_min_throughput(nodes, pods, timeout_s):
    res = run_benchmark(WorkloadConfig("SchedulingBasic", nodes, 0, pods), quiet=True,
                        timeout_s=timeout_s, device="cpu")
    assert res.unscheduled == 0, f"{res.unscheduled} pods unscheduled"
    if res.throughput_pods_per_s < WARNING:
        logger.warning("density %dn throughput %.1f pods/s below warning level %.0f",
                       nodes, res.throughput_pods_per_s, WARNING)
    assert res.throughput_pods_per_s >= THRESHOLD, (
        f"density {nodes}n throughput {res.throughput_pods_per_s:.1f} "
        f"pods/s below the {THRESHOLD:.0f} pods/s floor"
    )


def test_secrets_and_intree_pv_workloads_schedule():
    """Secret-volume pods ride the device path; in-tree-PV pods take the
    host fallback lane; both fully schedule."""
    r = run_benchmark(WorkloadConfig("SchedulingSecrets", 50, 0, 200), quiet=True,
                      timeout_s=240, device="cpu")
    assert r.unscheduled == 0
    r = run_benchmark(WorkloadConfig("SchedulingInTreePVs", 50, 0, 100), quiet=True,
                      timeout_s=240, device="cpu")
    assert r.unscheduled == 0
    assert "SchedulingSecrets/5000" in WORKLOADS
