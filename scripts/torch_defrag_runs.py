"""Repeat the port's defragmentation benchmark on the CUDA card.

Runs ``kubernetes_tpu_torch.perf.harness.run_defrag_benchmark`` at its
defaults (what ``chip_smoke.py``'s ``[defrag]`` phase runs) ``--runs``
times in one process and prints one JSON line per run: nodes and fleet
$/h before and after, plans, evictions, plan aborts and rejections by
reason, rollback uncordons, the time to quiesce, and the card's name and
power limit. It shows how often a consolidation plan is aborted (and
why) when the descheduler, the ReplicaSet controller and the Scheduler
race on the card::

    python3 scripts/torch_defrag_runs.py --runs 5
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def by_reason(metrics, name: str) -> dict:
    out: dict = {}
    for _n, labels, v in metrics.snapshot_counters(name):
        reason = labels.get("reason", "")
        out[reason] = out.get(reason, 0) + int(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_defrag_runs: no CUDA device available", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.perf.harness import run_defrag_benchmark
    from kubernetes_tpu_torch.utils.metrics import metrics

    card = card_line()
    for i in range(args.runs):
        t0 = time.perf_counter()
        res = run_defrag_benchmark(device="cuda")
        print(json.dumps({
            "run": i,
            "nodes": [res.nodes_before, res.nodes_after],
            "fleet_per_hour": [res.fleet_per_hour_before, res.fleet_per_hour_after],
            "plans": res.plans,
            "evictions": res.evictions,
            "aborts": by_reason(metrics, "descheduler_plan_aborts_total"),
            "rejected": by_reason(metrics, "descheduler_plan_rejected_total"),
            "rollback_uncordons": int(metrics.counter("descheduler_rollback_uncordons_total")),
            "bound_after": res.bound_after,
            "strictly_tighter": res.strictly_tighter,
            "time_to_quiesce_s": res.time_to_quiesce_s,
            "wall_s": round(time.perf_counter() - t0, 3),
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
