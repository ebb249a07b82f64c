"""One whole run of each cell on the card (``cuda``: skips without one)."""

import subprocess
import sys

import pytest

from schedbench.tests.small import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["basic-5k.backlog"])
def test_cell_on_the_card(workload):
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "schedbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "12", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]


def test_without_a_card_the_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "schedbench/run.py", "--workload", "basic-5k.backlog",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
