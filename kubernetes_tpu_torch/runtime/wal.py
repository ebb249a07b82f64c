"""Write-ahead log + snapshot persistence for the API store.

The reference's durability story is etcd (staging/src/k8s.io/apiserver/pkg/
storage/etcd3/store.go): every write is raft-logged before acknowledgment
and state survives any component crash. This collapses that into a
single-node WAL with the same crash-only contract: a mutation is
acknowledged only after its record is on disk; recovery = load latest
snapshot + replay the tail. Compaction writes a full snapshot and truncates
the log (etcd's snapshot/compact cycle).

Record format v2: one CRC32-framed JSON line per mutation
  K2 <crc32-hex8> {"rv": N, "verb": "create|update|delete", "kind": ..., "obj": {...}}
The CRC covers the JSON payload bytes (etcd frames WAL records the same
way), so recovery can tell a torn tail (crash mid-append: the damage is
the LAST thing in the log) from mid-log corruption (a flipped bit with
valid acked records after it — a medium fault, not a crash). The reader
version-sniffs per line: a line starting with `{` is a legacy v1 record
(plain JSON, no CRC) and stays recoverable forever.
Commit-index control records (runtime/consensus.py epoch transitions) share
the stream so replay sees durability state in log order:
  {"rv": N, "verb": "commit", "kind": "-", "obj": null,
   "commit": C, "term": T, "event": "degraded|restored"}
They carry the rv at which they were logged (so snapshot compaction
retires them naturally) but apply no object change; recovery tracks the
highest commit index seen (recover_full) and skips them during replay.
Snapshot format: {"rv": N, "objects": {resource: [obj, ...]}}

Disk fail-stop: a write or fsync error on the sink POISONS it permanently
(the fsyncgate lesson: after a failed fsync the kernel may have dropped
the dirty pages, so a retried fsync that "succeeds" proves nothing —
PostgreSQL shipped that bug for 20 years). Every subsequent append raises
SinkFailed without touching the file; the store is expected to go
degraded read-only and let a disk-healthy replica take over. The ONE
recoverable case is ENOSPC on the data write itself (before fsync): the
log is repaired back to the last acked record boundary and DiskFull is
raised — retryable once space frees, because no dirty-page state was
lost.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import serialization
from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.wal")

SNAPSHOT_SUFFIX = ".snapshot.json"
LOG_SUFFIX = ".wal"

# v2 frame: "K2 " + 8 hex chars of crc32(payload) + " " + payload
FRAME_PREFIX = "K2 "

# recovery classification + repair (the four disk failure modes)
COUNTER_TORN_TAIL = "wal_torn_tail_truncations_total"
COUNTER_MIDLOG = "wal_midlog_corruptions_total"
COUNTER_RETRIES_EXHAUSTED = "wal_recover_retries_exhausted_total"
COUNTER_TMP_SWEEPS = "wal_orphan_tmp_sweeps_total"
# sink fail-stop + pressure
COUNTER_SINK_FAILURES = "wal_sink_failures_total"
COUNTER_ENOSPC = "wal_enospc_errors_total"
GAUGE_SINK_FAILED = "wal_sink_failed"
GAUGE_CORRUPT = "wal_recovered_corrupt"
# slow-disk watchdog: a dying disk's fsyncs stretch long before they fail
HIST_FSYNC = "wal_fsync_duration_seconds"
COUNTER_FSYNC_STALLS = "wal_fsync_stalls_total"
GAUGE_FSYNC_STALLED = "wal_fsync_stalled"
# disk-space probe (store-level family: the gate acts on it)
GAUGE_FREE_BYTES = "store_disk_free_bytes"

_DEBUG = bool(os.environ.get("KTPU_WAL_DEBUG"))


def _trace(path: str, msg: str) -> None:
    if not _DEBUG:
        return
    import time as _t

    with open(path + ".trace", "a", encoding="utf-8") as f:
        f.write(f"{_t.monotonic():.6f} [{threading.get_ident()}] {msg}\n")


class SinkFailed(OSError):
    """The WAL sink hit a write/fsync error and is permanently poisoned
    (fail-stop). The record was NOT made durable; the mutation must not be
    acknowledged. Not retryable in this process — recovery is failover to
    a disk-healthy replica."""


class DiskFull(OSError):
    """ENOSPC on the data write, caught BEFORE fsync: the log was repaired
    to the last acked record boundary and the sink stays usable.
    Retryable once disk space frees."""


def frame_record(payload: str) -> str:
    """CRC32-frame one JSON payload into a v2 WAL line."""
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{FRAME_PREFIX}{crc:08x} {payload}\n"


def parse_wal_line(line: str) -> Optional[dict]:
    """Parse one WAL line (either framing version) or None if damaged.

    v2 (`K2 <crc8> <json>`): the CRC must match the payload bytes — a
    bit-flip inside a string value still parses as JSON, only the CRC
    catches it. v1 (starts with `{`): plain JSON, best-effort. Anything
    else is damage."""
    if line.startswith(FRAME_PREFIX):
        body = line[len(FRAME_PREFIX):]
        if len(body) < 10 or body[8] != " ":
            return None
        try:
            want = int(body[:8], 16)
        except ValueError:
            return None
        payload = body[9:]
        if zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF != want:
            return None
        try:
            rec = json.loads(payload)
        except json.JSONDecodeError:
            return None
        return rec if isinstance(rec, dict) else None
    if line.startswith("{"):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return None
        return rec if isinstance(rec, dict) else None
    return None


@dataclasses.dataclass
class RecoveryReport:
    """What recovery found, beyond the recovered state itself. `corrupt`
    means mid-log damage with valid acked records after it: the returned
    state is the longest valid prefix and the replica must resync from a
    healthy peer before serving it as authoritative."""

    rv: int = 0
    objects: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    commit: int = 0
    snap_rv: int = 0
    torn_tail: bool = False
    corrupt: bool = False
    bad_records: int = 0
    retries_exhausted: bool = False


class DiskSpaceProbe:
    """Low-watermark free-space probe with hysteresis: pressure enters at
    `low_bytes` free and clears at `high_bytes` (default 2x low), so the
    store goes read-only BEFORE appends start failing with ENOSPC and
    doesn't flap at the boundary. `statvfs` and `clock` are injectable
    for deterministic fault tests (testing/diskfaults.py)."""

    def __init__(
        self,
        path: str,
        low_bytes: int = 32 << 20,
        high_bytes: Optional[int] = None,
        statvfs: Callable = os.statvfs,
        min_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dir = os.path.dirname(os.path.abspath(path)) or "."
        self.low_bytes = low_bytes
        self.high_bytes = high_bytes if high_bytes is not None else low_bytes * 2
        self._statvfs = statvfs
        self._clock = clock
        self._min_interval_s = min_interval_s
        self._last_check: Optional[float] = None
        self.under_pressure = False

    def free_bytes(self) -> int:
        st = self._statvfs(self.dir)
        return int(st.f_bavail) * int(st.f_frsize)

    def check(self) -> Optional[bool]:
        """Returns True on entering pressure, False on recovering, None on
        no transition (including rate-limited skips and probe errors)."""
        now = self._clock()
        if (
            self._last_check is not None
            and now - self._last_check < self._min_interval_s
        ):
            return None
        self._last_check = now
        try:
            free = self.free_bytes()
        except OSError:
            return None
        metrics.set_gauge(GAUGE_FREE_BYTES, float(free))
        if not self.under_pressure and free < self.low_bytes:
            self.under_pressure = True
            return True
        if self.under_pressure and free >= self.high_bytes:
            self.under_pressure = False
            return False
        return None


class WriteAheadLog:
    # an fsync (or native group-commit wait) slower than this trips the
    # stall watchdog: a dying disk stretches fsyncs long before erroring
    FSYNC_STALL_S = 1.0

    def __init__(
        self,
        path: str,
        compact_every: int = 50_000,
        fsync: bool = True,
        native: bool = True,
    ):
        """`path` is a prefix: <path>.wal + <path>.snapshot.json.

        fsync=True (the DEFAULT, matching etcd: acknowledged means on
        media) fsyncs every append before the mutation is acknowledged.
        fsync=False trades media-durability for throughput — the write is
        still flushed to the OS, so it survives process crashes but not
        machine crashes (etcd's --unsafe-no-fsync testing mode); benchmarks
        and tests may opt out explicitly.

        native=False forces the pure-Python sink even when the C++
        group-commit sink is buildable — fault injection patches the
        Python sink seams (_sink_write/_sink_fsync)."""
        self.path = path
        self.log_path = path + LOG_SUFFIX
        self.snap_path = path + SNAPSHOT_SUFFIX
        self.compact_every = compact_every
        self.fsync = fsync
        self.allow_native = native
        self._lock = threading.Lock()
        self._since_compact = 0
        os.makedirs(os.path.dirname(os.path.abspath(self.log_path)), exist_ok=True)
        self._f = None
        self._native = None  # (lib, handle) when the C++ sink is in use
        self._closed = False
        self._failed: Optional[str] = None
        self._good_offset = 0
        # fired (once) when the sink poisons, with the reason — the store
        # flips its write gate to disk-failed read-only here. Called with
        # the wal lock held: callbacks must be cheap flag flips and must
        # never call back into the WAL.
        self._on_disk_failed: List[Callable[[str], None]] = []
        self.swept_tmp_files = self._sweep_tmp_files()
        self.repaired = self._repair_log()
        self._open_sink()

    # -- sink lifecycle ------------------------------------------------------

    def _open_sink(self) -> None:
        """Prefer the native group-commit sink (kubernetes_tpu/native):
        appends become enqueue+wait tickets and a batch of N records costs
        ONE fsync (etcd's wal.Save group commit). Python file IO otherwise."""
        if self.allow_native:
            from ..native import load_walsink

            lib = load_walsink()
            if lib is not None:
                h = lib.wal_open(self.log_path.encode(), 1 if self.fsync else 0)
                if h:
                    self._native = (lib, h)
                    return
        self._f = open(self.log_path, "a", encoding="utf-8")
        self._good_offset = self._f.seek(0, os.SEEK_END)

    def _close_sink(self) -> None:
        if self._native is not None:
            lib, h = self._native
            lib.wal_close(h)
            self._native = None
        if self._f is not None:
            self._f.close()
            self._f = None

    @property
    def native(self) -> bool:
        return self._native is not None

    @property
    def failed(self) -> Optional[str]:
        """The poison reason, or None while the sink is healthy."""
        return self._failed

    def on_disk_failed(self, cb: Callable[[str], None]) -> None:
        """Register a fail-stop listener (store write-gate wiring)."""
        self._on_disk_failed.append(cb)

    def _poison_locked(self, why: str) -> None:
        """Fail-stop: mark the sink permanently dead. Never reopened, never
        retried — a failed fsync means the kernel may have already dropped
        the dirty pages, so any retry that 'succeeds' is a lie."""
        if self._failed is not None:
            return
        self._failed = why
        metrics.inc(COUNTER_SINK_FAILURES)
        metrics.set_gauge(GAUGE_SINK_FAILED, 1.0)
        logger.error(
            "WAL sink FAILED (fail-stop, not retryable): %s — store must go "
            "read-only and yield to a disk-healthy replica",
            why,
        )
        try:
            self._close_sink()
        except OSError:
            pass
        for cb in list(self._on_disk_failed):
            try:
                cb(why)
            except Exception:
                logger.exception("disk-failed callback raised")

    def fsync_count(self) -> int:
        """Committer fsyncs so far (native sink only; stats/tests)."""
        if self._native is None:
            return -1
        lib, h = self._native
        return int(lib.wal_fsync_count(h))

    # -- startup repair ------------------------------------------------------

    def _sweep_tmp_files(self) -> int:
        """Remove snapshot/log `.tmp` leftovers from a crash mid-compaction.
        Both are pre-publish staging files (os.replace is the publish), so
        an orphan is never part of recoverable state — just disk leak."""
        swept = 0
        for p in (self.snap_path + ".tmp", self.log_path + ".tmp"):
            try:
                os.unlink(p)
            except FileNotFoundError:
                continue
            except OSError:
                logger.exception("orphan tmp sweep failed for %s", p)
                continue
            swept += 1
            logger.warning("swept orphaned compaction tmp file %s", p)
        if swept:
            metrics.inc(COUNTER_TMP_SWEEPS, by=float(swept))
        return swept

    def _repair_log(self) -> Optional[str]:
        """Physically truncate the log at the first damaged record before
        appending to it. Without this, new appends land AFTER the damage
        and a torn tail mutates into mid-log corruption on the next
        recovery. Returns "torn"/"corrupt"/None. The dropped suffix of a
        corrupt log was already refused by recovery (longest-valid-prefix
        contract) — truncating makes the file agree with the served state
        so replication resync can heal by re-appending from the prefix."""
        try:
            with open(self.log_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            return None
        offset = 0
        bad_at: Optional[int] = None
        valid_after_bad = False
        for raw in data.splitlines(keepends=True):
            line = raw.decode("utf-8", errors="replace").strip()
            end = offset + len(raw)
            if line:
                ok = parse_wal_line(line) is not None
                # a parseable final line missing its newline was never
                # acked (the \n is fsynced with the payload): torn
                if ok and not raw.endswith(b"\n"):
                    ok = False
                if not ok and bad_at is None:
                    bad_at = offset
                elif ok and bad_at is not None:
                    valid_after_bad = True
            offset = end
        if bad_at is None:
            return None
        kind = "corrupt" if valid_after_bad else "torn"
        if valid_after_bad:
            metrics.inc(COUNTER_MIDLOG)
            logger.error(
                "WAL %s: mid-log corruption at byte %d with valid records "
                "after it — truncating to the valid prefix; this replica "
                "must resync from a healthy peer before leading",
                self.log_path,
                bad_at,
            )
        else:
            metrics.inc(COUNTER_TORN_TAIL)
            logger.warning(
                "WAL %s: torn tail at byte %d (crash mid-append) — truncated",
                self.log_path,
                bad_at,
            )
        try:
            with open(self.log_path, "rb+") as f:
                f.truncate(bad_at)
        except OSError:
            logger.exception("WAL tail repair failed for %s", self.log_path)
            return kind
        return kind

    # -- write path ----------------------------------------------------------

    @staticmethod
    def _record(rv: int, verb: str, kind: str, obj: Any) -> str:
        rec = {
            "rv": rv,
            "verb": verb,
            "kind": kind,
            "obj": serialization.encode(obj) if obj is not None else None,
        }
        return frame_record(json.dumps(rec, default=str))

    def append(self, rv: int, verb: str, kind: str, obj: Any) -> None:
        self.append_batch([(rv, verb, kind, obj)])

    def append_batch(self, records: List[Tuple[int, str, str, Any]]) -> None:
        """Durably append records IN ORDER; acknowledged once ALL are on
        disk. With the native sink the whole batch (plus any concurrent
        appenders') shares one fsync."""
        self._append_lines([self._record(*r) for r in records])

    def append_commit(self, rv: int, commit: int, term: int, event: str) -> None:
        """Durably log a commit-index epoch transition (consensus mode:
        entering/leaving degraded read-only). Same fsync contract as a
        mutation record — the epoch boundary must survive a crash."""
        rec = {
            "rv": rv,
            "verb": "commit",
            "kind": "-",
            "obj": None,
            "commit": commit,
            "term": term,
            "event": event,
        }
        self._append_lines([frame_record(json.dumps(rec))])

    def _sink_write(self, data: str) -> None:
        """Python-sink write seam (patched by testing/diskfaults.py)."""
        self._f.write(data)
        self._f.flush()

    def _sink_fsync(self) -> None:
        """Python-sink fsync seam (patched by testing/diskfaults.py)."""
        os.fsync(self._f.fileno())

    def _append_lines(self, lines: List[str]) -> None:
        if not lines:
            return
        with self._lock:
            if self._failed is not None:
                raise SinkFailed(f"WAL sink poisoned (fail-stop): {self._failed}")
            t0 = time.monotonic()
            if self._native is not None:
                lib, h = self._native
                ticket = 0
                for line in lines:
                    data = line.encode()
                    ticket = lib.wal_enqueue(h, data, len(data))
                if lib.wal_wait(h, ticket) != 0:
                    # the record is NOT durable, the mutation must not be
                    # acknowledged — and the sink can't say whether the
                    # failure was the write or the fsync, so fail-stop
                    self._poison_locked("native sink write/fsync failed")
                    raise SinkFailed("WAL sink write/fsync failed")
                self._observe_fsync_locked(time.monotonic() - t0)
            else:
                try:
                    self._sink_write("".join(lines))
                except OSError as e:
                    if e.errno == errno.ENOSPC:
                        self._repair_enospc_locked(e)  # raises
                    self._poison_locked(f"write failed: {e}")
                    raise SinkFailed(f"WAL write failed: {e}") from e
                if self.fsync:
                    try:
                        self._sink_fsync()
                    except OSError as e:
                        # fsyncgate: the pages this fsync failed on may be
                        # gone from the page cache — even an ENOSPC here
                        # poisons, because retrying can't prove durability
                        self._poison_locked(f"fsync failed: {e}")
                        raise SinkFailed(f"WAL fsync failed: {e}") from e
                self._observe_fsync_locked(time.monotonic() - t0)
                self._good_offset = self._f.tell()
            self._since_compact += len(lines)
            if _DEBUG:
                rvs = [(parse_wal_line(line.rstrip("\n")) or {}).get("rv") for line in lines]
                _trace(self.path, f"append acked rvs={rvs} native={self._native is not None}")

    def _repair_enospc_locked(self, cause: OSError) -> None:
        """ENOSPC before fsync is the one recoverable sink error: nothing
        durable was promised yet, so roll the file back to the last acked
        record boundary and raise DiskFull (retryable once space frees).
        If even the repair fails, fall through to fail-stop."""
        metrics.inc(COUNTER_ENOSPC)
        try:
            try:
                self._f.close()  # discard buffered partial data
            except OSError:
                pass
            self._f = open(self.log_path, "a", encoding="utf-8")
            self._f.truncate(self._good_offset)
        except OSError as e:
            self._poison_locked(f"ENOSPC repair failed: {e}")
            raise SinkFailed(f"WAL ENOSPC and repair failed: {e}") from cause
        logger.warning(
            "WAL append hit ENOSPC; log repaired to last acked record "
            "(offset %d) — store should enter disk-pressure read-only",
            self._good_offset,
        )
        raise DiskFull(
            errno.ENOSPC,
            "WAL append failed: no space left on device "
            "(log repaired to last acked record; retry after space frees)",
        ) from cause

    def _observe_fsync_locked(self, dt: float) -> None:
        if not self.fsync:
            return
        metrics.observe(HIST_FSYNC, dt)
        stalled = dt >= self.FSYNC_STALL_S
        if stalled:
            metrics.inc(COUNTER_FSYNC_STALLS)
            logger.warning(
                "WAL fsync stalled: %.3fs (threshold %.1fs) — disk may be dying",
                dt,
                self.FSYNC_STALL_S,
            )
        metrics.set_gauge(GAUGE_FSYNC_STALLED, 1.0 if stalled else 0.0)

    def due(self) -> bool:
        with self._lock:
            return self._since_compact >= self.compact_every

    def write_snapshot(self, rv: int, objects: Dict[str, List[Any]]) -> None:
        """Publish a snapshot at `rv` and drop log records it covers.
        Serialization happens OUTSIDE the wal lock (and the caller runs this
        off the store's mutation path — see APIServer._compact_async);
        appends racing the compaction are preserved by rewriting, not
        truncating, the log tail. I/O errors propagate to the caller (which
        counts and backs off) — with the sink reopened first, so a failed
        compaction never wedges the append path."""
        snap = {
            "rv": rv,
            "objects": {
                kind: [serialization.encode(o) for o in objs]
                for kind, objs in objects.items()
            },
        }
        if _DEBUG:
            _trace(self.path, f"compact start rv={rv} nobjs={sum(len(v) for v in objects.values())}")
        tmp = self.snap_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snap, f, default=str)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            if self._closed:
                return  # shut down mid-compaction: don't resurrect the sink
            if self._failed is not None:
                return  # poisoned sink: no log rewrite, no reopen
            os.replace(tmp, self.snap_path)  # atomic publish
            _trace(self.path, f"snapshot published rv={rv}")
            # rewrite the log keeping only records newer than the snapshot
            # (the sink is closed around the rewrite and reopened after —
            # appends are excluded by the wal lock for the duration)
            self._close_sink()
            log_tmp = self.log_path + ".tmp"
            try:
                keep: List[str] = []
                with open(self.log_path, encoding="utf-8") as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if not line:
                            continue
                        rec = parse_wal_line(line)
                        if rec is not None and rec.get("rv", 0) > rv:
                            keep.append(line)
                # ATOMIC rotation (tmp + replace): a concurrent recover()
                # must never observe a truncated in-place rewrite — it sees
                # either the old full log or the rewritten tail, both
                # consistent with the published snapshot
                with open(log_tmp, "w", encoding="utf-8") as f:
                    for line in keep:
                        f.write(line + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(log_tmp, self.log_path)
                self._since_compact = len(keep)
            except OSError:
                try:
                    os.unlink(log_tmp)
                except OSError:
                    pass
                raise
            finally:
                # ALWAYS reopen (or poison trying): an exception above used
                # to leave the sink closed forever — every later append
                # died and compaction was wedged for the process lifetime
                try:
                    self._open_sink()
                except OSError as e:
                    self._poison_locked(f"sink reopen after compaction failed: {e}")
            if _DEBUG:
                _trace(self.path, f"log rewritten keep={len(keep)}")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._close_sink()

    # -- recovery ------------------------------------------------------------

    @staticmethod
    def recover(path: str) -> Tuple[int, Dict[str, Dict[str, Any]]]:
        """Load snapshot + replay log tail. Returns (rv, {kind: {key: obj}})."""
        report = WriteAheadLog.recover_report(path)
        return report.rv, report.objects

    @staticmethod
    def recover_full(
        path: str,
    ) -> Tuple[int, Dict[str, Dict[str, Any]], int]:
        """Load snapshot + replay log tail. Returns
        (rv, {kind: {key: obj}}, commit_index) — commit_index is the
        highest consensus commit index recorded in the log (0 when the
        store never ran in consensus mode; the consistency checker ranks
        surviving replicas by it)."""
        report = WriteAheadLog.recover_report(path)
        return report.rv, report.objects, report.commit

    @staticmethod
    def recover_report(path: str) -> RecoveryReport:
        """Full recovery with damage classification (RecoveryReport).

        Tolerates a torn final record (crash mid-append), like etcd's WAL
        CRC-truncate on recovery; REFUSES to replay past mid-log
        corruption — the returned state is snapshot + longest valid prefix
        and `corrupt` is set so the caller resyncs from a healthy peer
        instead of silently serving a log with acked records missing.

        Crash-point consistency: the compactor publishes the snapshot
        (atomic replace) BEFORE rewriting the log, so every on-disk state a
        crash can leave behind recovers fully. A LIVE writer compacting
        concurrently (tests; split-brain probes) can still interleave our
        two reads — stale snapshot paired with an already-rewritten log
        tail, silently losing the records in between. Detected by
        re-reading the snapshot rv after the log and retrying unless it
        still equals the rv of the snapshot we actually loaded (comparing
        against the REPLAYED rv is not enough: tail records replayed past
        the new snapshot's rv would mask the staleness — found by a
        14/25-pod recovery under a compacting writer). etcd forbids the
        scenario outright via flock."""
        report = RecoveryReport()
        for _ in range(10):
            report = WriteAheadLog._recover_once(path)
            if _DEBUG:
                _trace(path, f"recover pass snap_rv={report.snap_rv} rv={report.rv}")
            snap_path = path + SNAPSHOT_SUFFIX
            try:
                with open(snap_path, encoding="utf-8") as f:
                    current_rv = json.load(f)["rv"]
            except FileNotFoundError:
                current_rv = 0
            except (json.JSONDecodeError, OSError):
                continue  # snapshot replaced mid-read: retry
            if current_rv == report.snap_rv:
                # no snapshot was published between our two reads, so the
                # log tail we replayed is consistent with the snapshot we
                # loaded (a pending rewrite of THIS snapshot's log only
                # drops records the snapshot already covers)
                WriteAheadLog._count_damage(path, report)
                return report
        # a live writer compacted under us 10 times in a row (or the
        # snapshot is unreadable): the state below may pair a stale
        # snapshot with a newer log tail — say so instead of returning it
        # as if it were clean (satellite: this used to fall through silent)
        report.retries_exhausted = True
        metrics.inc(COUNTER_RETRIES_EXHAUSTED)
        logger.error(
            "WAL recovery of %s exhausted its 10 staleness retries — the "
            "returned state may pair a stale snapshot with a newer log "
            "tail; re-run recovery once the writer is quiesced",
            path,
        )
        WriteAheadLog._count_damage(path, report)
        return report

    @staticmethod
    def _count_damage(path: str, report: RecoveryReport) -> None:
        if report.corrupt:
            metrics.inc(COUNTER_MIDLOG)
            metrics.set_gauge(GAUGE_CORRUPT, 1.0)
            logger.error(
                "WAL %s: mid-log corruption (%d bad record(s) with valid "
                "acked records after) — recovered the longest valid prefix "
                "(rv=%d); REFUSING to serve the post-damage suffix, resync "
                "from a healthy peer",
                path,
                report.bad_records,
                report.rv,
            )
        elif report.torn_tail:
            metrics.inc(COUNTER_TORN_TAIL)
            logger.warning(
                "WAL %s: torn tail (%d damaged trailing record(s), crash "
                "mid-append) — truncated at the last acked record (rv=%d)",
                path,
                report.bad_records,
                report.rv,
            )

    @staticmethod
    def _recover_once(path: str) -> RecoveryReport:
        report = RecoveryReport()
        objects = report.objects
        snap_path = path + SNAPSHOT_SUFFIX
        log_path = path + LOG_SUFFIX
        if os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            report.rv = report.snap_rv = snap["rv"]
            for kind, objs in snap["objects"].items():
                d = objects.setdefault(kind, {})
                for data in objs:
                    obj = serialization.decode(kind, data)
                    d[obj.metadata.key] = obj
        if os.path.exists(log_path):
            bad_seen = False
            with open(log_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = parse_wal_line(line)
                    if rec is None:
                        # damaged record: stop replaying, keep scanning to
                        # classify (torn tail vs mid-log corruption)
                        report.bad_records += 1
                        bad_seen = True
                        continue
                    if bad_seen:
                        # a valid acked record AFTER damage: this is not a
                        # crash artifact, it is medium corruption — never
                        # replay past it (the rv sequence has a hole)
                        report.corrupt = True
                        continue
                    verb = rec.get("verb")
                    if verb == "commit":
                        # consensus epoch record: no object change; it may
                        # share a data record's rv, so handle BEFORE the
                        # rv-dedup skip below
                        report.commit = max(report.commit, int(rec.get("commit", 0)))
                        continue
                    if rec["rv"] <= report.rv:
                        continue  # already in snapshot
                    report.rv = rec["rv"]
                    kind = rec["kind"]
                    d = objects.setdefault(kind, {})
                    if verb == "delete":
                        obj = serialization.decode(kind, rec["obj"])
                        d.pop(obj.metadata.key, None)
                    else:
                        obj = serialization.decode(kind, rec["obj"])
                        d[obj.metadata.key] = obj
            if bad_seen and not report.corrupt:
                report.torn_tail = True
        return report
