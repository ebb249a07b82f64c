#!/usr/bin/env python
"""The port's soak on the CUDA card: sustained mixed churn against the
whole in-process control plane, the counterpart of ``scripts/soak.py``.

    python3 scripts/torch_soak.py [minutes] [n_nodes]   (defaults 10, 40)

Runs ``kubernetes_tpu_torch.perf.soak.run_soak`` on the card (it raises
without one). Prints a progress line a minute while the churn runs, then a
``[sample]`` line at each whole minute of the run, the reference's ``SOAK
PASS/FAIL`` line with its field names, and last one ``SAMPLES`` JSON line:
the samples at 2 minutes, at the end of the churn and at the peak of
allocated device memory, criteria (a) ``memory_steady`` and (b)
``retiring_clear``, each audit round, K1's launches, and the card's name
and power limit from nvidia-smi. Exits 0 only when the reference's checks,
(a) and (b) all pass.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kubernetes_tpu_torch.perf.soak import (  # noqa: E402
    card_line,
    peak_sample,
    run_soak,
    sample_at,
)


def report(res, card: str) -> int:
    """Prints the run's lines; the exit code."""
    for minute in range(1, int(res.samples[-1]["t_s"] // 60) + 1 if res.samples else 1):
        s = sample_at(res.samples, 60.0 * minute)
        if s is not None:
            print(f"[sample] {minute}m {json.dumps(s, sort_keys=True)}", flush=True)
    print(res.line(), flush=True)
    churn_end = next((s for s in res.samples if s["phase"] == "churn-end"), None)
    print("SAMPLES " + json.dumps({
        "minutes": res.minutes,
        "n_nodes": res.n_nodes,
        "churn_s": round(res.churn_s, 3),
        "at_2m": sample_at(res.samples, 120.0),
        "churn_end": churn_end,
        "peak": peak_sample(res.samples),
        "memory_steady": res.memory_steady,
        "retiring_clear": res.retiring_clear,
        "audits": res.audits,
        "k1_launches": res.k1_launches,
        "device": res.device,
        "card": card,
    }, sort_keys=True), flush=True)
    return 0 if res.ok and res.memory_steady is True and res.retiring_clear else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    minutes = float(argv[0]) if argv else 10.0
    n_nodes = int(argv[1]) if len(argv) > 1 else 40
    res = run_soak(minutes, n_nodes=n_nodes)
    return report(res, card_line())


if __name__ == "__main__":
    raise SystemExit(main())
