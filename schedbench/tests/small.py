"""A cell cut to a size the CPU runs in seconds, for the tests."""

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
SEED = 2**31 + 77
WORKLOAD = "basic-5k.backlog"


def shrink(cfg: dict, traffic: dict) -> None:
    # above the Scheduler's small_batch_host_node_max (256): a pop of a
    # few pods takes the device path, as at the cells' 5,000 nodes
    cfg["num_nodes"] = 260
    cfg["num_init_pods"] = 100
    cfg["scheduler"]["device_batch_size"] = 256
    cfg["scheduler"]["wave_m_cand"] = 64
    cfg["resident_measured_pods"] = 512
    traffic["unbound"] = 1024


def with_zone_affinity(cfg: dict, traffic: dict) -> None:
    """``shrink``, and every pod labelled app=bench with a required pod
    affinity to app=bench over the zone: the reference's affinity path,
    which no cell of BENCHMARK.json takes yet."""
    shrink(cfg, traffic)
    cfg["init_pod_labels"] = {"app": "bench"}
    cfg["pod_labels"] = {"app": "bench"}
    cfg["required_pod_affinity"] = {
        "match_labels": {"app": "bench"}, "topology_key": cfg["zone_label"],
    }


def run_small(affinity=False, seed=SEED, seconds=4.0, **kw):
    from schedbench.cell import run_cell

    return run_cell(WORKLOAD, seed, seconds, False, "cpu", time.monotonic(),
                    adjust=with_zone_affinity if affinity else shrink, **kw)
