"""The control's readings on the card, at a cell's own size and load.

    python3 schedbench/control.py --workload basic-5k.backlog \\
        --seeds 11,12,13 --seconds 12

Runs the cell once per seed in one process, with a short window, and
prints one JSON line a seed: every number the reference compares for
the program's held batch, and the same numbers for each control, the
reference put in the program's place in bfloat16
(``reference.control_held``: the whole score, or only its variable
part). The benchmark's own runs do not run it;
``schedbench/tests/test_sb_control.py`` holds it at a CPU size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from schedbench.cell import run_cell
    from schedbench.reference import CONTROLS

    for seed in (int(s) for s in a.seeds.split(",")):
        res = run_cell(a.workload, seed, a.seconds, False, "cuda:0", time.monotonic(),
                       control=True)
        vals = {k: c["value"] for k, c in res["checks"].items()}
        line = {
            "workload": a.workload, "seed": seed, "correct": res["correct"],
            "program": {k: v for k, v in vals.items() if "." not in k},
        }
        for kind in CONTROLS:
            line[kind] = {k[len(kind) + 1:]: v for k, v in vals.items()
                          if k.startswith(kind + ".")}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
