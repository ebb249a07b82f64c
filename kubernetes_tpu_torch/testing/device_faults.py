"""Deterministic data-plane fault injection for chaos tests.

The control-plane chaos suites inject faults at the store boundary
(ChaosStore); this module is the data-plane sibling — it corrupts the
three trust surfaces the scheduler's self-defense subsystem watches:

  * **snapshot rows** (`corrupt_device_rows`): flip columns of the
    HBM-resident DeviceSnapshot WITHOUT touching the host masters — the
    drift the anti-entropy auditor must detect and repair;
  * **kernel outputs** (`DeviceFaultInjector.nan_scores_on_readbacks`,
    `wild_rows_on_readbacks`): poison the read-back result arrays (NaN
    scores / out-of-range chosen rows) — what the batch guards must
    quarantine;
  * **launch/readback failures** (`fail_launches`, `fail_readbacks`):
    raise DeviceLossError on the Nth wave launch or readback — what the
    device-loss ride-through must retry, reshard, or ride out to the
    host path.

Everything is counter-indexed (0-based call ordinals), never random —
a chaos scenario is a statement, not a dice roll.

PyTorch port of ``kubernetes_tpu/testing/device_faults.py``. The seams
are the port's Scheduler's: ``_launch_wave_kernel(kern, snap, batch,
ptab, weights, noise)`` returns ``(new_snap, res, copies)`` and
``_run_serial_kernel(kern, snap, batch, noise, weights)`` returns
``(res, chosen, score, bulk)``; the tie noise is a tensor where the
reference passes a PRNG key. ``corrupt_device_rows`` reads one field of
the pinned generation, mutates the rows on the host and installs the
result as a new device tensor through ``swap_live_snapshot``, keeping a
sharded generation's placement (the new field split into fresh blocks on
their entries' devices), as the reference's version keeps its sharding.
"""

from __future__ import annotations

import threading
from typing import Iterable

import numpy as np
import torch

from ..ops.encoding import ShardedSnapshot, gather_snapshot
from ..parallel.sharded import DeviceLossError

__all__ = [
    "DeviceLossError",
    "DeviceFaultInjector",
    "corrupt_device_rows",
]


def corrupt_device_rows(
    encoder,
    rows: Iterable[int],
    field: str = "requested",
    mutate=None,
) -> None:
    """Flip the given rows of one DeviceSnapshot field IN DEVICE STATE
    only (host masters untouched): the exact shape of a scatter-drift or
    bit-flip bug. Default mutation adds a large constant so every
    resource column visibly diverges. Runs under a generation pin (the
    read must not observe tensors a wave launch donates mid-read) and
    installs the corrupted field — a new tensor on the field's device —
    as a new generation that shares its untouched tensors with the
    pinned one."""
    with encoder.pin_generation() as lease:
        dev = lease.snap
        if dev is None:
            raise RuntimeError("no device snapshot to corrupt (flush first)")
        src = getattr(gather_snapshot(dev), field)
        arr = np.array(src.cpu().numpy())
        idx = list(rows)
        if mutate is None:
            if arr.dtype.kind == "b":
                arr[idx] = ~arr[idx]
            else:
                arr[idx] = arr[idx] + np.asarray(7919, arr.dtype)
        else:
            arr[idx] = mutate(arr[idx])
        if isinstance(dev, ShardedSnapshot):
            encoder.swap_live_snapshot(dev.with_field(field, arr))
            return
        new = torch.tensor(arr, device=src.device)
        encoder.swap_live_snapshot(dev._replace(**{field: new}))


class DeviceFaultInjector:
    """Wraps one Scheduler's device seams (_launch_wave_kernel /
    _fetch_wave_results / _fetch_wave_index / _fetch_wave_bulk /
    _run_serial_kernel). Ordinals count calls made AFTER install().

    Split-phase mapping: the fast index fetch shares the readback
    ordinal space with the legacy combined fetch — `fail_readbacks` and
    `wild_rows_on_readbacks` land there (the chosen-row payload rides
    the fast path). The score tensor only exists on the TRAILING bulk
    fetch in split mode, so `nan_scores_on_readbacks` ordinals index
    bulk calls there, and `fail_trailing_readbacks` kills the trailing
    fetch itself — the exact late-disagreement the unwind machinery
    must catch after the fast payload already drove assumes."""

    def __init__(
        self,
        fail_launches: Iterable[int] = (),
        fail_all_launches: bool = False,
        fail_readbacks: Iterable[int] = (),
        nan_scores_on_readbacks: Iterable[int] = (),
        wild_rows_on_readbacks: Iterable[int] = (),
        fail_all_serials: bool = False,
        fail_trailing_readbacks: Iterable[int] = (),
    ):
        self.fail_launches = set(fail_launches)
        self.fail_all_launches = fail_all_launches
        self.fail_readbacks = set(fail_readbacks)
        self.nan_scores_on_readbacks = set(nan_scores_on_readbacks)
        self.wild_rows_on_readbacks = set(wild_rows_on_readbacks)
        self.fail_all_serials = fail_all_serials
        self.fail_trailing_readbacks = set(fail_trailing_readbacks)
        self.launch_calls = 0
        self.readback_calls = 0
        self.bulk_calls = 0
        self.serial_calls = 0
        self.injected = []  # (kind, ordinal) audit trail for assertions
        self._lock = threading.Lock()
        self._sched = None

    # -- installation --------------------------------------------------------

    def install(self, sched) -> "DeviceFaultInjector":
        self._sched = sched
        self._real_launch = sched._launch_wave_kernel
        self._real_fetch = sched._fetch_wave_results
        self._real_fetch_index = sched._fetch_wave_index
        self._real_fetch_bulk = sched._fetch_wave_bulk
        self._real_serial = sched._run_serial_kernel
        sched._launch_wave_kernel = self._launch
        sched._fetch_wave_results = self._fetch
        sched._fetch_wave_index = self._fetch_index
        sched._fetch_wave_bulk = self._fetch_bulk
        sched._run_serial_kernel = self._serial
        return self

    def uninstall(self) -> None:
        if self._sched is not None:
            self._sched._launch_wave_kernel = self._real_launch
            self._sched._fetch_wave_results = self._real_fetch
            self._sched._fetch_wave_index = self._real_fetch_index
            self._sched._fetch_wave_bulk = self._real_fetch_bulk
            self._sched._run_serial_kernel = self._real_serial
            self._sched = None

    # -- seams ---------------------------------------------------------------

    def _launch(self, kern, snap, batch, ptab, weights, noise):
        with self._lock:
            n = self.launch_calls
            self.launch_calls += 1
            boom = self.fail_all_launches or n in self.fail_launches
            if boom:
                self.injected.append(("launch_loss", n))
        if boom:
            raise DeviceLossError(
                f"injected: device lost on launch #{n}"
            )
        return self._real_launch(kern, snap, batch, ptab, weights, noise)

    def _serial(self, kern, snap, batch, noise, weights=None):
        with self._lock:
            n = self.serial_calls
            self.serial_calls += 1
            boom = self.fail_all_serials
            if boom:
                self.injected.append(("serial_loss", n))
        if boom:
            raise DeviceLossError(
                f"injected: device lost on serial kernel call #{n}"
            )
        return self._real_serial(kern, snap, batch, noise, weights)

    def _fetch(self, batches):
        with self._lock:
            n = self.readback_calls
            self.readback_calls += 1
            boom = n in self.fail_readbacks
            nan = n in self.nan_scores_on_readbacks
            wild = n in self.wild_rows_on_readbacks
        if boom:
            self.injected.append(("readback_loss", n))
            raise DeviceLossError(
                f"injected: device lost on readback #{n}"
            )
        fetched = self._real_fetch(batches)
        out = []
        for chosen, placed, deferred, score in fetched:
            chosen = np.array(chosen)
            placed = np.array(placed)
            score = np.array(score)
            if nan and placed.any():
                score = score.copy()
                score[np.nonzero(placed)[0][0]] = np.nan
                self.injected.append(("nan_score", n))
            if wild and placed.any():
                chosen = chosen.copy()
                chosen[np.nonzero(placed)[0][0]] = 2**30
                self.injected.append(("wild_row", n))
            out.append((chosen, placed, deferred, score))
        return out

    def _fetch_index(self, batches):
        """Split-phase FAST seam: index payload only. Shares the
        readback ordinal space with the legacy combined fetch."""
        with self._lock:
            n = self.readback_calls
            self.readback_calls += 1
            boom = n in self.fail_readbacks
            wild = n in self.wild_rows_on_readbacks
        if boom:
            self.injected.append(("readback_loss", n))
            raise DeviceLossError(
                f"injected: device lost on readback #{n}"
            )
        fetched = self._real_fetch_index(batches)
        out = []
        for chosen, placed, deferred in fetched:
            chosen = np.array(chosen)
            placed = np.array(placed)
            if wild and placed.any():
                chosen = chosen.copy()
                chosen[np.nonzero(placed)[0][0]] = 2**30
                self.injected.append(("wild_row", n))
            out.append((chosen, placed, deferred))
        return out

    def _fetch_bulk(self, entries):
        """Split-phase TRAILING seam: the bulk score payload, fetched
        after the fast payload's placements were already acted on."""
        with self._lock:
            n = self.bulk_calls
            self.bulk_calls += 1
            boom = n in self.fail_trailing_readbacks
            nan = n in self.nan_scores_on_readbacks
        if boom:
            self.injected.append(("trailing_loss", n))
            raise DeviceLossError(
                f"injected: device lost on trailing readback #{n}"
            )
        scores = self._real_fetch_bulk(entries)
        out = []
        for e, score in zip(entries, scores):
            score = np.array(score)
            placed = np.asarray(e.placed, dtype=bool)
            if nan and placed.any():
                score = score.copy()
                score[np.nonzero(placed)[0][0]] = np.nan
                self.injected.append(("nan_score", n))
            out.append(score)
        return out
