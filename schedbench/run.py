"""The benchmark of kubernetes_tpu_torch's Scheduler: one run of one cell.

    python3 schedbench/run.py --workload basic-5k.backlog \\
        --seed 1234 --seconds 40 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card. It
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number the reference compared,
each beside its limit, also printed as the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result; if the window's process has loaded JAX or the JAX
package it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's caches inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the port's process must not
    hold, compared whole: ``kubernetes_tpu_torch`` is not
    ``kubernetes_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[a.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s)", file=sys.stderr)
        return 2

    from schedbench.cell import run_cell

    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run's process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        lim = f"<= {c['max']}" if "max" in c else (f">= {c['min']}" if "min" in c else "")
        print(f"check {name} = {c['value']} {lim}".rstrip(), file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
