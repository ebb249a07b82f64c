"""Repeat one scheduling workload through the port's Scheduler and list its
wave batches.

Runs ``kubernetes_tpu_torch.perf.harness.run_benchmark`` on one workload
of ``perf/workloads.py`` at its defined size, with the configuration
``chip_smoke.py``'s ``[suite]`` gives it, ``--runs`` times in one process,
on the CUDA card. Prints one JSON line per run:
pods/s, batches, pod creation seconds, and the (pods, placed) of every
wave batch the Scheduler committed, in order (the initial pods' batches
first), with the card's name and power limit. It shows where a burst's
batches stop placing a full batch, e.g. a hard-spread burst's change of
mode::

    python3 scripts/torch_workload_batches.py --workload TopologySpreading/5000 --runs 2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="TopologySpreading/5000")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_workload_batches: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    wl = WORKLOADS[args.workload]
    for run in range(args.runs):
        with chip_smoke.RunCounts() as counts:
            res = run_benchmark(
                wl, sched_config=chip_smoke.suite_config(wl), device=device,
                timeout_s=600.0,
            )
        print(json.dumps({
            "workload": args.workload, "run": run,
            "scheduled": res.scheduled, "measured": res.num_measured_pods,
            "pods_per_s": res.throughput_pods_per_s, "batches": res.n_batches,
            "create_s": res.create_s, "committed": counts.batches, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
