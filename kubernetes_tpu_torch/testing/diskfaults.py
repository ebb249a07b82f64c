"""Deterministic disk-fault injection for the durability chaos suite.

The data-plane sibling (`device_faults.py`) corrupts device memory; this
module corrupts the STORAGE trust surface — the write-ahead log's sink —
which is what the disk-fault ride-through machinery defends:

  * **fsync failures** (`fail_fsyncs`, `fail_all_fsyncs`): raise EIO on
    the Nth fsync — the fsyncgate scenario. The WAL must fail-stop
    (poison permanently), never retry-and-pretend;
  * **write failures** (`fail_writes`): raise EIO on the Nth sink write
    — same fail-stop contract, caught one syscall earlier;
  * **ENOSPC** (`enospc_writes`, `enospc_after_bytes`): raise ENOSPC on
    chosen writes, or on every write once a cumulative byte budget is
    exhausted (a filling disk). `free_space()` simulates reclaim — the
    store must ride through: degrade to read-only, repair the log tail,
    and auto-reopen once retries find space again;
  * **slow fsync** (`slow_fsyncs` + `fsync_delay_s`): sleep before the
    real fsync — what the fsync stall watchdog must flag;
  * **torn writes** (`torn_writes`): persist only a prefix of the data,
    then raise EIO — a torn tail recovery must truncate, never replay.

Everything is counter-indexed (0-based call ordinals counted AFTER
`install()`), never random — a chaos scenario is a statement, not a
dice roll. Module helpers (`bit_flip_record`, `truncate_log_at`,
`chop_log_tail`) mutate the log FILE between process lifetimes for
crash-point and bit-rot scenarios.
"""

from __future__ import annotations

import errno
import threading
import time
import zlib
from typing import Iterable, Optional

from ..runtime.wal import FRAME_PREFIX

__all__ = [
    "DiskFaultInjector",
    "bit_flip_record",
    "truncate_log_at",
    "chop_log_tail",
]


class DiskFaultInjector:
    """Wraps one WriteAheadLog's sink seams (_sink_write / _sink_fsync).
    Only meaningful on the Python sink — construct the WAL with
    ``native=False`` so the seams are actually on the write path.

    Ordinals count calls made AFTER install(). The injector survives the
    WAL's own ENOSPC repair (close/reopen) because it patches the
    instance attributes, and the original bound methods read the live
    file handle at call time.
    """

    def __init__(
        self,
        fail_writes: Iterable[int] = (),
        fail_fsyncs: Iterable[int] = (),
        fail_all_fsyncs: bool = False,
        enospc_writes: Iterable[int] = (),
        enospc_after_bytes: Optional[int] = None,
        slow_fsyncs: Iterable[int] = (),
        fsync_delay_s: float = 0.0,
        torn_writes: Iterable[int] = (),
    ):
        self.fail_writes = set(fail_writes)
        self.fail_fsyncs = set(fail_fsyncs)
        self.fail_all_fsyncs = fail_all_fsyncs
        self.enospc_writes = set(enospc_writes)
        self.enospc_after_bytes = enospc_after_bytes
        self.slow_fsyncs = set(slow_fsyncs)
        self.fsync_delay_s = fsync_delay_s
        self.torn_writes = set(torn_writes)
        self.write_calls = 0
        self.fsync_calls = 0
        self.bytes_written = 0
        self.injected = []  # (kind, ordinal) audit trail for assertions
        self._lock = threading.Lock()
        self._wal = None

    # -- installation --------------------------------------------------------

    def install(self, wal) -> "DiskFaultInjector":
        if getattr(wal, "_native", None) is not None:
            raise RuntimeError(
                "DiskFaultInjector needs the Python sink: construct the "
                "WAL with native=False"
            )
        self._wal = wal
        self._real_write = wal._sink_write
        self._real_fsync = wal._sink_fsync
        wal._sink_write = self._write
        wal._sink_fsync = self._fsync
        return self

    def uninstall(self) -> None:
        if self._wal is not None:
            self._wal._sink_write = self._real_write
            self._wal._sink_fsync = self._real_fsync
            self._wal = None

    def free_space(self) -> None:
        """Simulate reclaim: lift the cumulative-bytes ENOSPC budget so
        the next retried write succeeds (the disk-pressure ride-through
        exit path)."""
        with self._lock:
            self.enospc_after_bytes = None

    # -- seams ---------------------------------------------------------------

    def _write(self, data: str) -> None:
        nbytes = len(data.encode("utf-8"))
        with self._lock:
            n = self.write_calls
            self.write_calls += 1
            eio = n in self.fail_writes
            torn = n in self.torn_writes
            enospc = n in self.enospc_writes or (
                self.enospc_after_bytes is not None
                and self.bytes_written + nbytes > self.enospc_after_bytes
            )
            if eio:
                self.injected.append(("write_eio", n))
            elif torn:
                self.injected.append(("torn_write", n))
            elif enospc:
                self.injected.append(("write_enospc", n))
            else:
                self.bytes_written += nbytes
        if eio:
            raise OSError(errno.EIO, f"injected: I/O error on write #{n}")
        if torn:
            # persist a prefix, then fail — the shape of a crash landing
            # mid-write(2). Recovery must classify the partial record as
            # a torn tail and truncate it.
            self._real_write(data[: max(1, len(data) // 2)])
            raise OSError(errno.EIO, f"injected: torn write #{n}")
        if enospc:
            raise OSError(
                errno.ENOSPC,
                f"injected: no space left on device (write #{n})",
            )
        self._real_write(data)

    def _fsync(self) -> None:
        with self._lock:
            n = self.fsync_calls
            self.fsync_calls += 1
            boom = self.fail_all_fsyncs or n in self.fail_fsyncs
            slow = n in self.slow_fsyncs
            if boom:
                self.injected.append(("fsync_eio", n))
            elif slow:
                self.injected.append(("fsync_stall", n))
        if boom:
            raise OSError(errno.EIO, f"injected: I/O error on fsync #{n}")
        if slow:
            time.sleep(self.fsync_delay_s)
        self._real_fsync()


# -- between-lifetimes file mutators ------------------------------------------


def bit_flip_record(log_path: str, ordinal: int, bit: int = 3) -> int:
    """Flip one bit inside the JSON payload of the Nth (0-based) record
    of a v2-framed log — bit-rot that the per-record CRC must catch even
    when the flipped byte still yields parseable JSON. Returns the
    absolute byte offset that was flipped."""
    with open(log_path, "rb") as f:
        raw = f.read()
    offset = 0
    seen = -1
    for line in raw.splitlines(keepends=True):
        body = line.rstrip(b"\n")
        if body.startswith(FRAME_PREFIX.encode()):
            seen += 1
            if seen == ordinal:
                # flip inside the payload (after "K2 " + 8 hex + " "),
                # mid-record so JSON usually still parses — proving the
                # CRC, not the JSON parser, is what catches bit-rot
                frame_len = len(FRAME_PREFIX) + 9
                payload_len = len(body) - frame_len
                target = offset + frame_len + payload_len // 2
                target = min(target, offset + len(body) - 2)
                mutated = bytearray(raw)
                mutated[target] ^= 1 << bit
                with open(log_path, "wb") as f:
                    f.write(bytes(mutated))
                return target
        offset += len(line)
    raise IndexError(
        f"log {log_path!r} has only {seen + 1} framed records, "
        f"wanted ordinal {ordinal}"
    )


def truncate_log_at(log_path: str, nbytes: int) -> None:
    """Truncate the log FILE to exactly nbytes — the crash-point
    property test sweeps this over every byte of the final record."""
    with open(log_path, "rb+") as f:
        f.truncate(nbytes)


def chop_log_tail(log_path: str, nbytes: int) -> int:
    """Chop nbytes off the end of the log (a torn final write). Returns
    the resulting file size."""
    with open(log_path, "rb+") as f:
        size = f.seek(0, 2)
        new = max(0, size - nbytes)
        f.truncate(new)
    return new


def _crc_ok(line: bytes) -> bool:
    """True when a v2-framed line's CRC matches its payload (test
    helper: lets assertions distinguish 'flipped payload' from 'flipped
    frame')."""
    body = line.rstrip(b"\n")
    if not body.startswith(FRAME_PREFIX.encode()):
        return False
    rest = body[len(FRAME_PREFIX):]
    try:
        want = int(rest[:8], 16)
    except ValueError:
        return False
    return zlib.crc32(rest[9:]) & 0xFFFFFFFF == want
