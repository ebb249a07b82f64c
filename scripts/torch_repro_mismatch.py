#!/usr/bin/env python
"""Small, aggressive twin of the port's soak, the counterpart of
``scripts/repro_mismatch.py``: the soak's pod create/delete churn past
capacity and node cordon flaps on a small cluster (nodes of 4 CPUs, no
controllers, no service churn) at the reproducer's faster rates, with a
quiesce-and-audit pass every minute. Each cycle churns for 45 s, deletes a
quarter of the bound pods (a capacity-release burst), lets the
unschedulable pool refill for 15 s, then audits ``requested``,
``nonzero_req``, ``sel_counts`` and ``port_counts`` of the device snapshot
against the host masters (a host copy of the flushed snapshot, under the
cache lock). On the first mismatch it prints the differing rows, the
assumed pods, the dirty rows and the pipeline's pending batches, and stops.

    python3 scripts/torch_repro_mismatch.py [minutes] [n_nodes]   (defaults 3, 10)

Runs on the CUDA card (it raises without one). The last line is the
reference's ``REPRO HIT/no-hit`` line, followed by the audits that ran,
the largest ``snapshot_generation_retiring`` they saw and the card's name
and power limit. As in the reference, the exit code is 0 when it hit a
mismatch and 1 when it did not.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kubernetes_tpu_torch.client.apiserver import NotFound  # noqa: E402
from kubernetes_tpu_torch.perf.soak import (  # noqa: E402
    Churn,
    SoakCluster,
    audit_once,
    card_line,
)

FIELDS = ("requested", "nonzero_req", "sel_counts", "port_counts")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    minutes = float(argv[0]) if argv else 3.0
    n_nodes = int(argv[1]) if len(argv) > 1 else 10
    cluster = SoakCluster(n_nodes, node_cpu="4", controllers=())
    server, sched = cluster.server, cluster.sched
    churn = Churn(cluster, pod_window=30, pod_sleep_s=0.005, flap_hold_s=0.2, flap_sleep_s=0.3)
    churn.start(churn.churn_pods, churn.flap_nodes)
    t0 = time.time()
    found = False
    cycle = 0
    audits, retiring_max = 0, 0.0
    try:
        while time.time() - t0 < minutes * 60 and not churn.errors and not found:
            cycle += 1
            time.sleep(45)  # churn phase: oversubscribe
            # capacity-release burst: delete ~25% of bound pods
            victims = [
                p for p in server.list("pods")[0]
                if p.spec.node_name and p.metadata.deletion_timestamp is None
            ]
            burst = victims[: max(1, len(victims) // 4)]
            for p in burst:
                try:
                    server.delete("pods", p.metadata.namespace, p.metadata.name)
                except NotFound:
                    pass
            print(
                f"[cycle {cycle}] deleted {len(burst)} bound pods "
                f"(t={time.time() - t0:.0f}s, created={churn.seq})",
                flush=True,
            )
            time.sleep(15)  # refill phase
            got = audit_once(sched, timeout_s=30.0, fields=FIELDS)
            if got is None:
                print("audit skipped: pipeline never quiesced", flush=True)
                continue
            audits += 1
            bad, retiring = got
            retiring_max = max(retiring_max, retiring or 0.0)
            if bad:
                found = True
                with sched.cache.lock:
                    enc = sched.cache.encoder
                    print(f"MISMATCH at t={time.time() - t0:.0f}s: {bad}", flush=True)
                    print(
                        f"  assumed={sorted(sched.cache._assumed.keys())[:8]} "
                        f"dirty={sorted(enc._dirty_rows)} "
                        f"pending={len(sched._pending)}",
                        flush=True,
                    )
    finally:
        churn.stop(join_s=5.0)
        cluster.stop()
    total = server.count("pods")
    bound = cluster.count_bound()
    print(
        f"REPRO {'HIT' if found else 'no-hit'}: created={churn.seq} pods={total} "
        f"bound={bound} errors={churn.errors[:3]} audits={audits} "
        f"retiring_max={retiring_max:g} card={card_line()}",
        flush=True,
    )
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
