"""Outcome scoring of the policy gym (port): the fragmentation score only.

``fragmentation_score`` is copied from ``kubernetes_tpu/tuner/scoring.py``
for ``Scheduler.fragmentation_score`` (the live-fleet gauge). The replay
half of that module — overlays, candidate replays, wave outcomes — runs
the serial lattice and is ROADMAP queue 1 item 2.
"""

from __future__ import annotations

import numpy as np


def fragmentation_score(
    free_frac: np.ndarray, used_any: np.ndarray, valid: np.ndarray
) -> float:
    """Stranded-capacity fragmentation in [0, 1]: free capacity sitting
    on PARTIALLY used nodes / total free capacity. A consolidating
    placement leaves whole nodes empty (gang-sized holes survive); a
    smearing one strands its slack. ONE definition shared by the gym's
    outcome scoring (score_assignment), the live-fleet gauge
    (Scheduler.fragmentation_score), and the descheduler's planning
    signal — inputs come from SnapshotEncoder.utilization_stats or the
    gym's overlay columns, both derived from the same masters."""
    valid = np.asarray(valid, bool)
    stranded_mask = np.asarray(used_any, bool) & valid
    total_free = float(free_frac[valid].sum())
    stranded = float(free_frac[stranded_mask].sum())
    return stranded / total_free if total_free > 0 else 0.0
