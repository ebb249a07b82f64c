"""Snapshot anti-entropy: background audit + repair of the HBM device state.

The data plane trusts two incremental protocols: the encoder's host masters
(per-pod add/remove deltas over numpy aggregates) and the device snapshot
(row scatters + kernel-committed occupancy). PRs 1 and 3 gave the API store
a detect → quarantine → repair → resume discipline; this module gives the
same to the device state, because a single silently-drifted row mis-places
every pod that scores that node until the process restarts.

Each audit pass (period `period_s`, under the cache lock, only while the
wave pipeline is quiescent — an in-flight batch legitimately holds device
commits the masters haven't replayed yet; that gate is SEMANTIC only:
mechanically the audit's row gather runs under a generation pin
(`SnapshotEncoder.pin_generation`), which a concurrent donating wave
launch cannot invalidate — it advances through a copy while the pinned
generation keeps serving the gather):

  1. **settle** — flush pending deltas so any remaining diff is drift, not
     an expected in-flight update;
  2. **master self-check** — re-encode the sampled rows' pod aggregates
     from the per-pod entries (`SnapshotEncoder.expected_row_aggregates`)
     and repair masters that drifted (an incremental-encoder bug or a
     half-applied update);
  3. **device diff** — fetch the sampled rows of every row-major device
     field in one transfer and compare column-wise against the masters
     (per-row checksums keyed by the cache generation: a row whose
     generation moved since the last pass gets a fresh baseline);
  4. **repair** — drifted rows are marked dirty and re-scattered by an
     immediate flush (targeted repair), then re-fetched to confirm;
  5. **escalate** — a row still wrong after its re-scatter, or
     `rebuild_after` consecutive drifting passes, forces a full snapshot
     rebuild (`invalidate_device` + flush) — device memory is a
     rebuildable cache (SURVEY.md §5).

Rows flagged by failure paths (`SnapshotEncoder.suspect_rows`, e.g. the
bulk-assume per-pod fallback) are audited first, every pass.

Counters/gauges (rendered by /metrics and the SIGUSR2 debugger dump):
  snapshot_drift_rows_total{column}   drifted row-columns detected
  snapshot_repaired_rows_total        rows repaired by targeted re-scatter
  snapshot_rebuilds_total             full-rebuild escalations
  snapshot_audit_passes_total         completed audit passes
  snapshot_audit_drift_rows           rows drifted in the LAST pass (gauge)
  snapshot_audit_consecutive_drift    consecutive drifting passes (gauge)

The generation-lifecycle series (`snapshot_generation_*`, emitted by
ops/encoding.py: current id, pinned readers, retiring count, retired /
copy-on-pin / retire-stall counters, retirement-latency histogram) render
through the same `snapshot_` dump prefix, so a stuck reader pin is
observable in the SIGUSR2 dump, never a silent HBM leak.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.scheduler.antientropy")

COUNTER_DRIFT_ROWS = "snapshot_drift_rows_total"  # label: column
COUNTER_REPAIRED = "snapshot_repaired_rows_total"
COUNTER_REBUILDS = "snapshot_rebuilds_total"
COUNTER_PASSES = "snapshot_audit_passes_total"
GAUGE_LAST_DRIFT = "snapshot_audit_drift_rows"
GAUGE_CONSECUTIVE = "snapshot_audit_consecutive_drift"


class SnapshotAntiEntropy:
    """Periodic auditor for one SnapshotEncoder. `lock` (the scheduler
    cache's RLock) serializes against every other encoder writer;
    `quiesced` must return False while kernel-committed device state is
    legitimately ahead of the host masters (in-flight wave batches)."""

    def __init__(
        self,
        encoder: "SnapshotEncoder",
        lock=None,
        quiesced: Optional[Callable[[], bool]] = None,
        period_s: float = 5.0,
        sample_rows: int = 64,
        rebuild_after: int = 3,
    ):
        self.encoder = encoder
        self.lock = lock if lock is not None else contextlib.nullcontext()
        self.quiesced = quiesced
        self.period_s = period_s
        self.sample_rows = max(1, sample_rows)
        self.rebuild_after = max(1, rebuild_after)
        self._cursor = 0  # round-robin over live rows across passes
        self._consecutive_drift = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        def loop():
            while not self._stop.wait(self.period_s):
                try:
                    self.audit_once()
                except Exception:
                    # an audit failure must never take the process down —
                    # it is a diagnostic/repair loop, not a dependency
                    logger.exception("anti-entropy audit pass failed")
        self._thread = threading.Thread(
            target=loop, daemon=True, name="snapshot-antientropy"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- one pass ------------------------------------------------------------

    def _pick_rows(self, enc) -> List[int]:
        """Suspect rows first, then a round-robin window over the live
        rows so every row is audited within n/sample passes. The suspect
        set is NOT drained here — audit_once clears it only after the
        pass completes, so a mid-pass device error (fetch/flush raising)
        can't silently discard failure-flagged rows."""
        rows: List[int] = sorted(
            r for r in enc.suspect_rows if r < len(enc.row_names)
        )
        live = [
            r for r, name in enumerate(enc.row_names) if name is not None
        ]
        if live:
            start = self._cursor % len(live)
            take = min(self.sample_rows, len(live))
            window = [live[(start + i) % len(live)] for i in range(take)]
            self._cursor = (start + take) % len(live)
            rows.extend(r for r in window if r not in rows)
        return rows

    def audit_once(self) -> Dict[str, object]:
        """One audit/repair pass; returns a report dict (tests + SIGUSR2).

        Every device write in this pass goes through
        ``flush(donate=False)`` — the alias-free ``_scatter_rows_safe``
        program — so the auditor can never donate (and thereby corrupt)
        the live snapshot it is repairing. No donation site remains in
        this body, so no alias-safe marker is needed (the stale-pragma
        audit retired the one that used to sit here)."""
        enc = self.encoder
        # the retire-stall watchdog otherwise only runs on new lease
        # traffic: sweep it from this periodic pass (before any skip
        # path) so a leaked reader pin on an idle encoder still surfaces
        # in /metrics instead of silently holding its HBM generation
        enc.check_retire_stalls()
        report: Dict[str, object] = {
            "rows_audited": 0,
            "master_repaired": [],
            "device_drift": {},
            "rebuilt": False,
            "skipped": None,
        }
        with self.lock:
            if self.quiesced is not None and not self.quiesced():
                report["skipped"] = "pipeline busy"
                return report
            if enc._device is None:
                report["skipped"] = "no device snapshot"
                return report
            generation = enc.generation
            # settle pending deltas: after this flush, any device/master
            # difference is drift by definition. donate=False throughout
            # the audit: repair/settle scatters use the alias-free program
            # so the auditor can never corrupt the state it is fixing (the
            # donating in-place variant has been observed writing garbage
            # when deserialized from a persistent compilation cache).
            if enc.has_pending_updates:
                enc.flush(donate=False)
            rows = self._pick_rows(enc)
            if not rows:
                report["skipped"] = "no live rows"
                return report
            report["rows_audited"] = len(rows)
            report["generation"] = generation

            # 2) master self-check against entry-derived expectations
            for r in rows:
                bad = enc.verify_row_aggregates(r, repair=True)
                if bad:
                    report["master_repaired"].append((r, bad))
                    for col in bad:
                        metrics.inc(COUNTER_DRIFT_ROWS, {"column": col})
            if report["master_repaired"]:
                logger.warning(
                    "anti-entropy: master aggregates drifted on rows %s "
                    "(repaired from pod entries)",
                    report["master_repaired"],
                )

            # 3) device diff, column-wise
            drifted = self._device_diff(enc, rows, report["device_drift"])

            # 4) targeted repair: dirty rows (master repairs + device
            # drift) re-scatter in one flush, then confirm
            if drifted:
                for r in drifted:
                    enc._dirty_rows.add(r)
            if enc.has_pending_updates:
                enc.flush(donate=False)
            still_bad: List[int] = []
            if drifted:
                # the confirm re-fetch must not double-bump the drift
                # counters (same rows, same pass), and only rows whose
                # re-scatter actually STUCK count as repaired
                still_bad = self._device_diff(
                    enc, sorted(drifted), {}, count=False
                )
                repaired = len(drifted) - len(still_bad)
                if repaired:
                    metrics.inc(COUNTER_REPAIRED, by=float(repaired))

            # 5) escalation: re-scatter didn't stick, or drift keeps
            # coming back pass after pass
            any_drift = bool(drifted or report["master_repaired"])
            self._consecutive_drift = (
                self._consecutive_drift + 1 if any_drift else 0
            )
            if still_bad or self._consecutive_drift >= self.rebuild_after:
                logger.error(
                    "anti-entropy: escalating to full snapshot rebuild "
                    "(unrepaired rows=%s, consecutive drifting passes=%d)",
                    still_bad,
                    self._consecutive_drift,
                )
                enc.invalidate_device()
                enc.flush(donate=False)
                metrics.inc(COUNTER_REBUILDS)
                report["rebuilt"] = True
                self._consecutive_drift = 0

            # pass complete: every suspect row was audited (or is a stale
            # index past the row table) — safe to drain now. The lock is
            # held for the whole pass, so nothing was flagged concurrently.
            enc.suspect_rows.clear()
            metrics.inc(COUNTER_PASSES)
            metrics.set_gauge(GAUGE_LAST_DRIFT, float(len(drifted)))
            metrics.set_gauge(
                GAUGE_CONSECUTIVE, float(self._consecutive_drift)
            )
        return report

    @staticmethod
    def _device_diff(
        enc, rows: List[int], out: Dict[str, List[int]], count: bool = True
    ) -> set:
        """Compare fetched device rows against the masters column-wise;
        fills `out` (field -> drifted row list), returns the drifted row
        set and bumps the per-column drift counters (`count=False` for
        the post-repair confirm fetch, which re-reads the same rows)."""
        drifted: set = set()
        fetched = enc.fetch_device_rows(rows)
        if fetched is None:
            return drifted
        idx = np.asarray(rows, np.int64)
        for field, dev in fetched.items():
            master = enc._master_of(field)[idx]
            dev = np.asarray(dev)
            if dev.shape != master.shape:
                # capacity grew between fetch and compare (impossible
                # under the lock, but cheap to guard)
                continue
            eq = (
                np.isclose(dev, master)
                if dev.dtype.kind == "f"
                else dev == master
            )
            bad = np.nonzero(~eq.reshape(len(rows), -1).all(axis=1))[0]
            if bad.size:
                bad_rows = [rows[int(b)] for b in bad]
                out[field] = bad_rows
                drifted.update(bad_rows)
                if count:
                    metrics.inc(
                        COUNTER_DRIFT_ROWS,
                        {"column": field},
                        by=float(bad.size),
                    )
                logger.warning(
                    "anti-entropy: device column %r drifted from masters "
                    "on rows %s",
                    field,
                    bad_rows,
                )
        return drifted


def dataplane_health_lines() -> List[str]:
    """Data-plane self-defense state — audit drift/rebuild counters,
    kernel-guard trips, device-loss events — rendered for the SIGUSR2
    debugger dump. Empty when none of those components has run yet."""
    lines: List[str] = []
    for prefix in (
        "snapshot_",
        "kernel_guard_",
        "scheduler_device_",
        "scheduler_mesh_",
        "scheduler_wave_",
    ):
        for name, labels, value in metrics.snapshot_gauges(prefix):
            annotation = ""
            if name == "scheduler_device_down":
                annotation = (
                    "DOWN (host-path fallback)" if value else "serving"
                )
            lines.append(
                metrics.format_series_line(name, labels, value, annotation)
            )
        for name, labels, value in metrics.snapshot_counters(prefix):
            lines.append(metrics.format_series_line(name, labels, value))
    return lines
