"""The comparison finds what it must: the control (the reference in
bfloat16 in the program's place) and the faults a wave batch can carry
come out not correct, while the program's own run is correct."""

import pytest

from schedbench.cell import passed
from schedbench.reference import CONTROLS
from schedbench.tests.small import run_small


def _faulty_kernel(sched, alter):
    """Wraps the launch seam so that every wave kernel's call goes through
    `alter(snap, result)` after the kernel ran."""
    inner = sched._launch_wave_kernel

    class Kern:
        def __init__(self, k):
            self._k = k

        def __getattr__(self, n):
            return getattr(self._k, n)

        def with_noise(self, snap, tb, pt, weights, noise):
            keep = snap.requested.clone(), snap.nonzero_req.clone(), snap.eterm_w.clone(), snap.sel_counts.clone()
            new_snap, res = self._k.with_noise(snap, tb, pt, weights, noise)
            alter(new_snap, res, keep)
            return new_snap, res

    def launch(kern, snap, batch, ptab, weights, noise):
        return inner(Kern(kern), snap, batch, ptab, weights, noise)

    sched._launch_wave_kernel = launch


def _answer_altered(sched):
    def alter(snap, res, keep):
        n = int(snap.valid.sum())
        res.chosen.copy_(((res.chosen + 1) % n) * res.placed + res.chosen * ~res.placed)

    _faulty_kernel(sched, alter)


def _state_unchanged(sched):
    def alter(snap, res, keep):
        snap.requested.copy_(keep[0])
        snap.nonzero_req.copy_(keep[1])
        snap.eterm_w.copy_(keep[2])
        snap.sel_counts.copy_(keep[3])

    _faulty_kernel(sched, alter)


def _control(res, kind):
    """The control's numbers of a run, each with the limit of its name."""
    out = {}
    for k, v in res["checks"].items():
        if k.startswith(kind + "."):
            name = k[len(kind) + 1:]
            out[name] = dict(v, **{x: res["checks"][name][x]
                                   for x in ("min", "max") if x in res["checks"][name]})
    return out


@pytest.mark.parametrize("affinity", [False, True], ids=["basic", "zone-affinity"])
def test_program_correct_control_not(affinity):
    res = run_small(affinity, control=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["snapshot_mismatch"]["value"] == 0
    assert res["checks"]["held_bind_mismatch"]["value"] == 0
    control = _control(res, "control")
    assert control and not passed(control), control
    assert control["score_gap"]["value"] > control["score_gap"]["max"]
    # the control that rounds only the variable part is read, not judged:
    # at these clusters' pod counts it lies within float32's step at the
    # constant (PERF.md)
    assert set(_control(res, "control_var")) == set(control)
    assert set(CONTROLS) == {"control", "control_var"}


# the numbers that judge what a wave batch produced (not the harness's own)
OUTPUT_CHECKS = {
    "score_gap", "topm_shortfall", "feasible_mismatch", "chosen_infeasible",
    "snapshot_mismatch", "snapshot_units", "held_bind_mismatch", "over_allocatable",
}


@pytest.mark.parametrize("fault", [_answer_altered, _state_unchanged])
def test_a_broken_wave_batch_is_not_correct(fault):
    res = run_small(fault=fault)
    assert not res["correct"], res["checks"]
    failing = {k for k, v in res["checks"].items() if "." not in k and not passed({k: v})}
    assert failing & OUTPUT_CHECKS, failing
