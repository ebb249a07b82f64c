"""Burst throughput and standby promotion of the port at its own defaults.

Runs the ``kubernetes_tpu_torch`` package found first on ``sys.path`` (set
``PYTHONPATH`` to the tree to measure) on the CUDA card, with that tree's
``perf/harness.default_config()``:

* ``run_benchmark`` of ``SchedulingPodAffinity/5000`` after one warm-up run
  of ``SchedulingPodAffinity/500`` presized to 5,000 nodes (what
  ``chip_smoke.py``'s ``[scheduler]`` phase runs);
* ``start_standby()`` on that workload's 5,000 nodes and 1,000 bound
  initial pods, 500 pods queued while it stands by, ``promote()``, and the
  time until all 500 are bound (``chip_smoke.py``'s ``[standby]``);
* with ``--latency-rate R``, ``run_latency_benchmark`` of that workload at
  R pods/s with 500 pods (``chip_smoke.py``'s ``[latency]`` at a fixed
  rate, so two trees see the same arrivals).

Prints one JSON line: the tree's label, pods/s, e2e p99, the standby's
warm-up, promotion and bind times, the latency run's pod p50/p99 when
asked, and the card's name and power limit.
To compare two commits in one chip call, unpack the other commit
(``git archive``) into a git-ignored directory and run this script once
per tree, in turns (parent, change, change, parent, ...)::

    PYTHONPATH=build/archive/parent python3 scripts/torch_defaults_ab.py --label parent
    PYTHONPATH=. python3 scripts/torch_defaults_ab.py --label change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def burst(device) -> dict:
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    run_benchmark(
        WORKLOADS["SchedulingPodAffinity/500"], presize_nodes=wl.num_nodes,
        device=device, timeout_s=300,
    )
    res = run_benchmark(wl, device=device, timeout_s=300)
    if res.unscheduled:
        raise SystemExit(f"{res.unscheduled} pods unbound")
    return {"pods_per_s": res.throughput_pods_per_s, "e2e_p99_ms": res.e2e_p99_ms}


def standby(device) -> dict:
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.perf.harness import default_config
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler import Scheduler

    nodes, init_pods, factory = build_workload(WORKLOADS["SchedulingPodAffinity/5000"])
    server = APIServer()
    for n in nodes:
        server.create("nodes", n)
    for i, p in enumerate(init_pods):
        p.spec.node_name = nodes[(7 * i) % len(nodes)].metadata.name
        server.create("pods", p)
    sched = Scheduler(server, default_config(), device=device)
    n_pods = 500
    try:
        t0 = time.perf_counter()
        sched.start_standby(identity="standby")
        warm_s = time.perf_counter() - t0
        for i in range(n_pods):
            server.create("pods", factory(i))
        deadline = time.monotonic() + 60
        while len(sched.queue) < n_pods and time.monotonic() < deadline:
            time.sleep(0.01)
        t1 = time.perf_counter()
        sched.promote()
        promote_ms = (time.perf_counter() - t1) * 1e3
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            bound = server.count(
                "pods", lambda p: p.metadata.name.startswith("pod-") and bool(p.spec.node_name)
            )
            if bound >= n_pods:
                break
            time.sleep(0.02)
        bound_s = time.perf_counter() - t1
    finally:
        sched.stop()
    if bound < n_pods:
        raise SystemExit(f"standby: {bound}/{n_pods} bound")
    return {"warm_s": warm_s, "promote_ms": promote_ms, "bound_s": bound_s}


def latency(device, rate: float) -> dict:
    from kubernetes_tpu_torch.perf.harness import run_latency_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    lat = run_latency_benchmark(
        WORKLOADS["SchedulingPodAffinity/5000"], rate, n_pods=500,
        device=device, timeout_s=120,
    )
    if lat.scheduled != 500:
        raise SystemExit(f"latency: {lat.scheduled}/500 bound")
    return {"latency_rate": rate, "pod_p50_ms": lat.pod_p50_ms, "pod_p99_ms": lat.pod_p99_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--latency-rate", type=float, default=0.0,
                    help="also run the latency benchmark at this rate (pods/s)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = {"label": args.label, **burst(device), **standby(device)}
    if args.latency_rate > 0:
        out.update(latency(device, args.latency_rate))
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
