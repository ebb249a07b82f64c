"""The wave replay ring: recent REAL waves, recorded for the gym.

The scheduler's device paths (wave pipeline + serial batch) call
``record_wave`` right after a batch commits: the pod specs, the weight
vector the kernel actually launched with, the rng key, the production
placements (row-aligned with ``pods``; ``""`` = unplaced) and the cache
generation the launch encoded against. The gym replays these pods
against a ``whatif_overlay`` copy of the CURRENT snapshot — deliberately
NOT a pinned launch-time generation: holding N reader pins would force
every subsequent wave launch through copy-on-pin, and the gym's question
("how would candidate W place this real traffic against this cluster")
is comparative — every candidate, incumbent included, replays the same
overlay, so drift between launch-time and replay-time state cancels out
of the ranking.

Records hold REFERENCES to the pod objects (replay only reads specs);
the ring is bounded, lock-leaf (nothing is acquired while holding it),
and Eraser-tracked like every shared structure in the tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from ..testing.lockgraph import named_lock, track_attrs
from ..utils.metrics import metrics
from .policy import COUNTER_WAVES_RECORDED, GAUGE_WAVE_RING_DEPTH


@dataclass
class WaveRecord:
    """One real wave: the inputs a replay needs plus the outcome
    production actually committed (the shadow diff / rollback
    baseline)."""

    pods: List[Any]  # v1.Pod references, batch order
    weights: np.ndarray  # [NUM_SCORE_COMPONENTS] launch vector
    placements: List[str] = field(default_factory=list)  # "" = unplaced
    rng_key: Any = None  # the launch PRNG key (serial path: exact replay)
    launch_gen: int = 0
    path: str = "wave"  # "wave" | "serial"
    seq: int = 0  # ring-assigned monotonic sequence


class WaveRingBuffer:
    """Bounded ring of recent waves. The scheduler writes (hot path —
    one list append under a leaf lock), the tuner reads snapshots."""

    def __init__(self, capacity: int = 32):
        self.capacity = max(1, int(capacity))
        self._lock = named_lock("tuner.ring")
        self._ring: List[WaveRecord] = []
        self._seq = 0

    def record_wave(
        self,
        pods: List[Any],
        weights: np.ndarray,
        placements: List[str],
        rng_key: Any = None,
        launch_gen: int = 0,
        path: str = "wave",
    ) -> None:
        if not pods:
            return
        rec = WaveRecord(
            pods=list(pods),
            weights=np.asarray(weights, np.float32).copy(),
            placements=list(placements),
            rng_key=rng_key,
            launch_gen=int(launch_gen),
            path=path,
        )
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            self._ring.append(rec)
            if len(self._ring) > self.capacity:
                del self._ring[: len(self._ring) - self.capacity]
            depth = len(self._ring)
        metrics.inc(COUNTER_WAVES_RECORDED, {"path": path})
        metrics.set_gauge(GAUGE_WAVE_RING_DEPTH, float(depth))

    def snapshot(
        self, limit: Optional[int] = None, min_seq: int = 0
    ) -> List[WaveRecord]:
        """Newest-last copy of the ring (records themselves are shared,
        treated as immutable once recorded). ``min_seq`` filters to waves
        recorded after a known point (post-promotion rollback watch)."""
        with self._lock:
            out = [r for r in self._ring if r.seq > min_seq]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring = []
        metrics.set_gauge(GAUGE_WAVE_RING_DEPTH, 0.0)


track_attrs(WaveRingBuffer, "_ring", "_seq")
