"""Length-prefixed compact binary codec for watch streams.

The newline-delimited JSON watch wire (rest.py `_serve_watch`) pays a
full ``codec.encode(obj)`` + ``json.dumps`` per DELIVERY: with 10k
informers on one kind, one store event becomes 10k independent JSON
encodes — pure overhead, measured as the dominant fan-out cost in the
PR-6 readpath bench. This codec replaces the per-delivery encode with a
per-EVENT frame: the object payload is the existing protobuf-wire
envelope (api/protocodec.py, ~3x denser than JSON), the frame is
immutable bytes, and the frame is memoized ON the Event object — the
same Event instance sits in every CacheWatcher queue of a kind's
fan-out, so N streams ship the SAME bytes and the encode happens once.

Negotiation (rest.py / apiserver/client.py): the client offers
``Accept: application/vnd.kubernetes-tpu.watchstream``; a server that
speaks it answers with that Content-Type and binary frames; an old
server ignores the unknown Accept and answers JSON lines — the client
branches on the RESPONSE Content-Type, so JSON remains the default and
the universal wire fallback (mixed fleets mid-upgrade just work).

Frame layout (all integers big-endian):

    frame    := type(1) length(4) payload(length)
    type 'A' | 'M' | 'D'  object event; payload = protocodec envelope
    type 'B'              bookmark; payload = rv as 8-byte unsigned
    type 'J'              JSON fallback event (custom resources — the
                          protocodec cannot encode Unstructured, same
                          restriction as the reference); payload is the
                          JSON line the legacy wire would have carried

Import-light (stdlib + api codecs): the balancer and chaos children
decode frames without touching jax.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional, Tuple

from ..api import protocodec
from ..api import serialization as codec
from ..runtime.watch import ADDED, BOOKMARK, DELETED, MODIFIED

# offered by clients in Accept, answered by speakers in Content-Type
WATCH_CONTENT_TYPE = "application/vnd.kubernetes-tpu.watchstream"

_HEADER = struct.Struct(">cI")
_RV = struct.Struct(">Q")

_TYPE_TO_CODE = {ADDED: b"A", MODIFIED: b"M", DELETED: b"D"}
_CODE_TO_TYPE = {b"A": ADDED, b"M": MODIFIED, b"D": DELETED}

# Event attribute carrying the memoized frame: the cacher fan-out hands
# ONE Event instance to every client queue, so the first stream to
# serialize it pays the encode and the rest ship the same bytes. The
# race (two streams encoding concurrently) is benign — both produce
# identical immutable frames and either may win the attribute store.
_MEMO_ATTR = "_watch_binframe"


def _frame(code: bytes, payload: bytes) -> bytes:
    return _HEADER.pack(code, len(payload)) + payload


def bookmark_frame(rv: int) -> bytes:
    """Bookmarks are per-stream (the idle heartbeat advertises each
    stream's own last-written rv) — never memoized, always cheap."""
    return _frame(b"B", _RV.pack(rv))


def event_frame(ev: Any) -> bytes:
    """The event's wire frame, memoized on the Event object itself."""
    memo: Optional[bytes] = getattr(ev, _MEMO_ATTR, None)
    if memo is not None:
        return memo
    obj = ev.object
    from ..api import objects as v1api

    code = _TYPE_TO_CODE.get(ev.type)
    if code is not None and not isinstance(obj, v1api.Unstructured):
        frame = _frame(code, protocodec.encode_obj(obj))
    else:
        # custom resources (and any future event type) ride the JSON
        # fallback frame: the codec stays total over the object model
        frame = _frame(
            b"J",
            json.dumps({"type": ev.type, "object": codec.encode(obj)}).encode(),
        )
    try:
        setattr(ev, _MEMO_ATTR, frame)
    except AttributeError:
        pass  # slotted/foreign event object: serve unmemoized
    return frame


def read_frame(fp) -> Optional[Tuple[str, int, Any]]:
    """Decode one frame from a file-like stream (the client pump side).

    Returns (event_type, rv, object) — object is None for bookmarks (rv
    carries the payload), a DECODED typed object for binary frames, and
    a JSON-ready dict for 'J' fallback frames (the caller resolves the
    kind, exactly like the legacy JSON line pump). Returns None on a
    clean EOF at a frame boundary; a truncated frame raises ValueError
    (the stream died mid-frame — a resume, not an EOF).
    """
    head = fp.read(_HEADER.size)
    if not head:
        return None
    if len(head) < _HEADER.size:
        raise ValueError("truncated watch frame header")
    code, length = _HEADER.unpack(head)
    payload = fp.read(length)
    if len(payload) < length:
        raise ValueError("truncated watch frame payload")
    if code == b"B":
        return BOOKMARK, _RV.unpack(payload)[0], None
    if code == b"J":
        msg = json.loads(payload)
        obj = msg.get("object") or {}
        rv = int((obj.get("metadata") or {}).get("resourceVersion", 0) or 0)
        return msg.get("type", ""), rv, obj
    ev_type = _CODE_TO_TYPE.get(code)
    if ev_type is None:
        raise ValueError(f"unknown watch frame type {code!r}")
    obj = protocodec.decode_obj(payload)
    return ev_type, int(obj.metadata.resource_version or 0), obj
