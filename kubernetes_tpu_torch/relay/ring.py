"""Seq-numbered shared-memory frame ring: the relay's fan-out bus.

The watch relay's economics depend on one fact: a watch frame is
immutable bytes encoded ONCE per event (apiserver/watchcodec.py
memoizes it on the Event object). This ring extends that sharing across
PROCESS boundaries: the frontend's publisher writes each kind's frames
exactly once into a `multiprocessing.shared_memory` segment, and every
relay worker process reads the same bytes with zero IPC round trips and
zero GIL sharing — fan-out cost scales with frames produced, not
clients connected.

Layout (all integers big-endian, one segment per kind):

    header (64 bytes, single writer):
        magic(4) version(4) capacity(8)
        head_seq(8) head_cum(8)            next record's seq / cum offset
        floor_seq(8) floor_cum(8)          oldest fully-retained record
        floor_rv(8)                        410 boundary (see below)
    record := seq+1(8) rv(8) type(1) length(4) payload(length)

Records are laid contiguously in a byte ring addressed by CUMULATIVE
offset (phys = cum % capacity, so positions are monotonic and a reader
can detect being lapped). A record never wraps: when the tail remaining
is too small the writer emits a PAD record ('P'), or — when even a
record header no longer fits — both sides skip to the boundary by the
same rule. `type` is the watch frame's own leading type byte ('A'/'M'/
'D'/'J' events, 'B' bookmarks), duplicated in the record header so
workers can branch without parsing payloads.

Concurrency model: ONE writer (the publisher), N reader processes, no
locks. Each record is a seqlock: the stored seq field is written as 0
(invalid) before the payload is touched and set to seq+1 only after the
payload is complete; a reader copies the payload and re-reads the seq —
any mismatch means the writer lapped it mid-copy and the reader resyncs
to the floor. Readers never block the writer and the writer NEVER
blocks on readers: a reader that stalls past the ring capacity simply
observes `lapped=True` and re-enters at the floor (its clients resume
through the cacher-window contract instead).

Floor / 410 contract (mirrors apiserver/cacher.py's window floor): the
ring retains a sliding window of recent frames; `floor_rv` is the
oldest resumable position. A client resuming at rv >= floor_rv replays
buffered frames with rv > its position; rv < floor_rv is Expired (410,
re-list). Evicting an EVENT record with resource version r advances
floor_rv to r+1 — exactly KindCache's `evicted.resource_version + 1`;
bookmark and pad evictions never advance it (a bookmark at rv r proves
nothing about events <= r still being needed: they were written, and
therefore evicted, before it).
"""

from __future__ import annotations

import struct
from collections import deque
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

_MAGIC = 0x4B545259  # "KTRY"
_VERSION = 1

_HEADER = struct.Struct(">IIQQQQQQ")  # magic ver cap head_seq head_cum floor_seq floor_cum floor_rv
HEADER_SIZE = 64
_REC = struct.Struct(">QQcI")  # seq+1, rv, type, payload length
REC_HDR = _REC.size

PAD = b"P"
BOOKMARK_TYPE = b"B"
# control record: the publisher lost continuity (its own cache watcher
# overflowed) and re-subscribed — workers shed every client of the kind
# so they resume through the cacher-window contract instead of silently
# missing events. Never forwarded to clients.
RESYNC_TYPE = b"R"

_HEAD_SEQ_OFF = 16
_FLOOR_OFF = 32  # floor_seq floor_cum floor_rv
_Q = struct.Struct(">Q")
_QQ = struct.Struct(">QQ")
_QQQ = struct.Struct(">QQQ")


class RingLapped(RuntimeError):
    """A reader fell more than one ring capacity behind the writer."""


def _unregister_tracker(shm: shared_memory.SharedMemory) -> None:
    """Python 3.10's SharedMemory registers ATTACHES with the resource
    tracker, which then unlinks the segment when the attaching process
    exits — destroying the ring under the publisher. Readers must not
    own the segment's lifetime; only the creator unlinks."""
    try:  # pragma: no cover - interpreter-version dependent
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


class FrameRing:
    """Writer handle over one kind's shared-memory frame ring."""

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int,
                 owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self.capacity = capacity
        self._owner = owner
        # writer-only state (reconstructed on attach from the header)
        (_, _, _, self._head_seq, self._head_cum, self._floor_seq,
         self._floor_cum, self._floor_rv) = _HEADER.unpack(
            bytes(self._buf[: _HEADER.size])
        )
        # (seq, start_cum, end_cum, rv, type) of live records, oldest
        # first — the writer's own eviction bookkeeping (readers only
        # ever see the header floor fields)
        self._live: deque = deque()

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, capacity: int = 1 << 22,
               name: Optional[str] = None) -> "FrameRing":
        shm = shared_memory.SharedMemory(
            create=True, size=HEADER_SIZE + capacity, name=name
        )
        shm.buf[: HEADER_SIZE] = b"\x00" * HEADER_SIZE
        shm.buf[: _HEADER.size] = _HEADER.pack(
            _MAGIC, _VERSION, capacity, 0, 0, 0, 0, 0
        )
        return cls(shm, capacity, owner=True)

    @classmethod
    def attach(cls, name: str) -> "FrameRing":
        shm = shared_memory.SharedMemory(name=name)
        _unregister_tracker(shm)
        magic, ver, cap = struct.unpack(">IIQ", bytes(shm.buf[:16]))
        if magic != _MAGIC or ver != _VERSION:
            shm.close()
            raise ValueError(f"not a frame ring: {name}")
        return cls(shm, cap, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except (OSError, BufferError):
            pass

    # -- header access (torn-read safe: single u64 fields, re-validated
    #    through the per-record seqlock on the reader side) ------------------

    def _write_head(self) -> None:
        self._buf[_HEAD_SEQ_OFF:_HEAD_SEQ_OFF + 16] = _QQ.pack(
            self._head_seq, self._head_cum
        )

    def _write_floor(self) -> None:
        self._buf[_FLOOR_OFF:_FLOOR_OFF + 24] = _QQQ.pack(
            self._floor_seq, self._floor_cum, self._floor_rv
        )

    def head(self) -> Tuple[int, int]:
        """(head_seq, head_cum) — re-read until stable."""
        while True:
            a = bytes(self._buf[_HEAD_SEQ_OFF:_HEAD_SEQ_OFF + 16])
            b = bytes(self._buf[_HEAD_SEQ_OFF:_HEAD_SEQ_OFF + 16])
            if a == b:
                return _QQ.unpack(a)

    def floor(self) -> Tuple[int, int, int]:
        """(floor_seq, floor_cum, floor_rv) — re-read until stable."""
        while True:
            a = bytes(self._buf[_FLOOR_OFF:_FLOOR_OFF + 24])
            b = bytes(self._buf[_FLOOR_OFF:_FLOOR_OFF + 24])
            if a == b:
                return _QQQ.unpack(a)

    def floor_rv(self) -> int:
        return self.floor()[2]

    # -- writer --------------------------------------------------------------

    def set_initial_floor(self, rv: int) -> None:
        """Publisher start: nothing older than `rv` will ever be in the
        ring, so a resume below it must 410 (the cacher itself may still
        cover it — the worker's state-sync path handles rv=0)."""
        self._floor_rv = max(self._floor_rv, rv)
        self._write_floor()

    def _evict_one(self) -> None:
        seq, _start, end, rv, ftype = self._live.popleft()
        self._floor_seq = seq + 1
        self._floor_cum = end
        if ftype not in (PAD, BOOKMARK_TYPE, RESYNC_TYPE):
            # KindCache's exact floor rule: evicted event rv + 1
            self._floor_rv = max(self._floor_rv, rv + 1)
        # publish the new floor BEFORE the writer overwrites the bytes:
        # a lapped reader resyncing mid-publish must land on a floor
        # whose records are all still intact
        self._write_floor()

    def _make_room(self, need: int) -> None:
        while self._head_cum + need - self._floor_cum > self.capacity:
            if not self._live:
                raise ValueError(
                    f"frame of {need} bytes exceeds ring capacity "
                    f"{self.capacity}"
                )
            self._evict_one()

    def _write_record(self, rv: int, ftype: bytes, payload) -> None:
        start = self._head_cum
        phys = start % self.capacity
        n = len(payload)
        base = HEADER_SIZE + phys
        # seqlock: invalidate first, payload second, seq last
        self._buf[base:base + 8] = _Q.pack(0)
        self._buf[base + 8:base + REC_HDR] = _REC.pack(
            0, rv, ftype, n
        )[8:]
        if n:
            self._buf[base + REC_HDR:base + REC_HDR + n] = payload
        self._buf[base:base + 8] = _Q.pack(self._head_seq + 1)
        end = start + REC_HDR + n
        self._live.append((self._head_seq, start, end, rv, ftype))
        self._head_seq += 1
        self._head_cum = end
        self._write_head()

    def publish(self, rv: int, frame) -> int:
        """Append one watch frame (the full wire bytes from
        apiserver/watchcodec — type byte included). Never blocks: slow
        readers are lapped, never waited for. Returns the record seq."""
        n = len(frame)
        if REC_HDR + n > self.capacity // 2:
            raise ValueError(
                f"frame of {n} bytes too large for ring capacity "
                f"{self.capacity}"
            )
        ftype = bytes(frame[:1]) or PAD
        phys = self._head_cum % self.capacity
        rem = self.capacity - phys
        if rem < REC_HDR:
            # tail too small for even a header: both sides skip by rule
            self._make_room(rem)
            self._head_cum += rem
            self._write_head()
        elif rem < REC_HDR + n:
            # pad record so the real record starts at offset 0
            self._make_room(rem)
            self._write_record(0, PAD, b"\x00" * (rem - REC_HDR))
        seq = self._head_seq
        self._make_room(REC_HDR + n)
        self._write_record(rv, ftype, frame)
        return seq


class RingReader:
    """One reader cursor over a FrameRing (per worker, per kind).

    `read_new()` returns frames published since the cursor, detecting
    laps via the per-record seqlock. A fresh reader starts at the FLOOR
    (not the head): a relay worker replacing a SIGKILLed sibling must
    rebuild the full retained window so reconnecting clients can resume
    at rvs from before the worker existed."""

    _RESYNC_BOUND = 8

    def __init__(self, ring: FrameRing, from_floor: bool = True):
        self.ring = ring
        if from_floor:
            self.seq, self.cum = ring.floor()[:2]
        else:
            self.seq, self.cum = ring.head()
        self.lapped_total = 0

    def _resync(self) -> None:
        self.seq, self.cum, _rv = self.ring.floor()
        self.lapped_total += 1

    def read_new(
        self, max_frames: int = 4096
    ) -> Tuple[List[Tuple[int, int, bytes, bytes]], bool]:
        """([(seq, rv, type, frame)], lapped). `lapped=True` means the
        cursor fell out of the ring and was reset to the floor — frames
        were MISSED and the caller must treat every downstream consumer
        as gapped (close clients; they resume via the cacher window)."""
        ring = self.ring
        buf = ring._buf
        cap = ring.capacity
        out: List[Tuple[int, int, bytes, bytes]] = []
        lapped = False
        resyncs = 0
        while len(out) < max_frames:
            head_seq, head_cum = ring.head()
            if self.cum >= head_cum:
                break
            phys = self.cum % cap
            rem = cap - phys
            if rem < REC_HDR:
                self.cum += rem  # writer's implicit boundary skip
                continue
            base = HEADER_SIZE + phys
            stored, rv, ftype, n = _REC.unpack(
                bytes(buf[base:base + REC_HDR])
            )
            if stored != self.seq + 1 or REC_HDR + n > cap:
                # overwritten under us (or torn): fall back to the floor
                resyncs += 1
                lapped = True
                if resyncs > self._RESYNC_BOUND:
                    break
                self._resync()
                continue
            payload = bytes(buf[base + REC_HDR:base + REC_HDR + n])
            # seqlock validate: unchanged seq proves the copy is whole
            if bytes(buf[base:base + 8]) != _Q.pack(self.seq + 1):
                resyncs += 1
                lapped = True
                if resyncs > self._RESYNC_BOUND:
                    break
                self._resync()
                continue
            if ftype != PAD:
                out.append((self.seq, rv, ftype, payload))
            self.seq += 1
            self.cum += REC_HDR + n
        return out, lapped
