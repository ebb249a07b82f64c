"""The held batch's start worked out from the stream alone: the store at
the launch, the batches in flight, the deletes not yet seen; and the
held batch's own bind call found by the rows its kernel chose."""

import numpy as np
import pytest

from schedbench.reference import held_start
from schedbench.window import ADD, BIND, DEL, Run

NAMES = ["node-0", "node-1", "node-2", "node-3", None]


def _stream():
    ev = [(ADD, i + 1, f"m-{i}", None, 0.0) for i in range(6)]
    ev += [(BIND, 7, "m-0", "node-0", 0.0), (BIND, 8, "m-1", "node-1", 0.0)]
    ev += [(DEL, 9, "m-0", "node-0", 0.0), (DEL, 10, "m-1", "node-1", 0.0)]
    # launched before the held batch, bound after its launch (rv 10)
    ev += [(BIND, 11, "m-2", "node-2", 0.0), (BIND, 12, "m-3", "node-2", 0.0)]
    # the held batch's own bind call
    ev += [(BIND, 13, "m-4", "node-3", 0.0), (BIND, 14, "m-5", "node-3", 0.0)]
    runs = [Run(1.0, 2, 6, 8), Run(2.0, 2, 10, 12), Run(3.0, 2, 12, 14)]
    return ev, runs


def _held(pods_col, chosen=(3, 3)):
    return {
        "names": NAMES, "rv": 10,
        "pods_col": np.array(pods_col), "chosen": np.array(chosen),
        "placed": np.ones(len(chosen), bool), "pod_valid": np.ones(len(chosen), bool),
    }


@pytest.mark.parametrize("pods_col, lag", [
    ([0, 0, 2, 0, 0], 0),  # every delete seen
    ([0, 1, 2, 0, 0], 1),  # the newest delete not yet seen
    ([1, 1, 2, 0, 0], 2),
])
def test_a_snapshot_behind_on_deletes_is_the_store_at_an_earlier_point(pods_col, lag):
    ev, runs = _stream()
    st = held_start(_held(pods_col), ev, runs)
    assert (st["snapshot_mismatch"], st["snapshot_lag"], st["held_bind_mismatch"]) == (0, lag, 0)
    assert st["counts"].tolist() == pods_col


@pytest.mark.parametrize("pods_col, mismatch", [
    ([0, 0, 0, 0, 0], 2),  # the batch in flight left out: a state left unchanged
    ([1, 0, 2, 0, 0], 1),  # an older delete unseen while a newer one is
    ([0, 0, 2, 0, 3], 3),  # pods on a row with no node
])
def test_a_snapshot_no_earlier_store_explains_is_a_mismatch(pods_col, mismatch):
    ev, runs = _stream()
    assert held_start(_held(pods_col), ev, runs)["snapshot_mismatch"] == mismatch


def test_a_bind_that_is_not_what_the_kernel_chose_is_a_mismatch():
    ev, runs = _stream()
    assert held_start(_held([0, 0, 2, 0, 0], chosen=(2, 3)), ev, runs)["held_bind_mismatch"] == 2
