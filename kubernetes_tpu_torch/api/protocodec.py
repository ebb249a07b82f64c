"""Binary (protobuf-wire-shaped) codec for the API object model.

The apimachinery protobuf serializer role (reference
staging/src/k8s.io/apimachinery/pkg/runtime/serializer/protobuf/protobuf.go):
a length-prefixed binary wire format negotiated via
``application/vnd.kubernetes.protobuf``, ~2-4x denser than JSON and
cheaper to scan. The envelope mirrors the reference's: the 4-byte magic
``k8s\\x00`` followed by an ``Unknown`` message carrying the TypeMeta and
the raw object bytes (protobuf.go's Unknown{TypeMeta, Raw}).

The body encoding is protobuf wire format (varint field headers, LEB128
varints, length-delimited submessages) over a schema derived
REFLECTIVELY from the dataclass model: field numbers are 1-based
dataclass field order. That makes this a self-consistent wire format —
both ends must share the object model, which holds everywhere in this
tree (the reference ships generated.pb.go for the same reason). Schema
evolution rule: append new dataclass fields, never reorder (the same
rule proto field numbers enforce).

Scalar mapping:
  bool/int     -> varint (zigzag, so negatives stay small)
  float        -> fixed64 little-endian double
  str          -> len-delimited UTF-8
  bytes        -> len-delimited
  dataclass    -> len-delimited submessage
  list/tuple   -> repeated field (one header per element)
  dict         -> repeated map-entry submessage {1: key, 2: value}
  Quantity/Any -> tagged scalar-union submessage {1: str, 2: varint,
                  3: double, 4: json-bytes} (JSON bytes carry anything
                  non-scalar, e.g. Unstructured content — the reference
                  likewise cannot protobuf-encode custom resources)

Like to_dict, encoding omits fields equal to their default (omitempty),
so wire size tracks the populated surface, not the schema width.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import typing
from typing import Any, Dict, List, Optional, Tuple, Type, get_args, get_origin, get_type_hints

from . import objects as v1
from .serialization import KIND_TO_RESOURCE, RESOURCE_KINDS

MAGIC = b"k8s\x00"
CONTENT_TYPE = "application/vnd.kubernetes.protobuf"

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _put_varint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


def _put_header(buf: bytearray, field: int, wire: int) -> None:
    _put_varint(buf, (field << 3) | wire)


# -- schema cache ------------------------------------------------------------

# class -> [(field_num, name, resolved_type)]; field numbers are 1-based
# dataclass declaration order (append-only evolution contract, see module
# docstring)
_SCHEMA: Dict[type, List[Tuple[int, str, Any]]] = {}
_DEFAULTS: Dict[type, Dict[str, Any]] = {}


def _resolve_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


# bare container hints (list, not List[X]) have no get_origin/get_args;
# normalize them to their Any-parameterized forms so the container
# branches fire
_BARE_HINTS = {
    list: List[Any],
    tuple: Tuple[Any, ...],
    dict: Dict[str, Any],
}


def _schema(cls: type) -> List[Tuple[int, str, Any]]:
    s = _SCHEMA.get(cls)
    if s is None:
        hints = get_type_hints(cls)
        s = _SCHEMA[cls] = [
            (i, f.name, _BARE_HINTS.get(hints[f.name], hints[f.name]))
            for i, f in enumerate(dataclasses.fields(cls), start=1)
        ]
        defaults = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                defaults[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                defaults[f.name] = f.default_factory()  # type: ignore[misc]
        _DEFAULTS[cls] = defaults
    return s


# -- encode ------------------------------------------------------------------


def _enc_union(buf: bytearray, field: int, val: Any) -> None:
    """Scalar-union / Any submessage: {1: str, 2: varint, 3: double,
    4: json bytes}. bool is NOT int here: JSON bytes keep its type."""
    sub = bytearray()
    if isinstance(val, str):
        _put_header(sub, 1, _WIRE_LEN)
        raw = val.encode()
        _put_varint(sub, len(raw))
        sub += raw
    elif isinstance(val, bool) or not isinstance(val, (int, float)):
        raw = json.dumps(val, default=str).encode()
        _put_header(sub, 4, _WIRE_LEN)
        _put_varint(sub, len(raw))
        sub += raw
    elif isinstance(val, int):
        _put_header(sub, 2, _WIRE_VARINT)
        _put_varint(sub, _zigzag(val))
    else:
        _put_header(sub, 3, _WIRE_FIXED64)
        sub += struct.pack("<d", val)
    _put_header(buf, field, _WIRE_LEN)
    _put_varint(buf, len(sub))
    buf += sub


def _enc_value(buf: bytearray, field: int, val: Any, tp: Any) -> None:
    tp = _resolve_optional(tp)
    origin = get_origin(tp)
    if dataclasses.is_dataclass(tp) and not origin:
        sub = _enc_message(val)
        _put_header(buf, field, _WIRE_LEN)
        _put_varint(buf, len(sub))
        buf += sub
        return
    if origin in (list, tuple):
        args = get_args(tp)
        if origin is tuple and args and Ellipsis not in args:
            # fixed-shape tuple (e.g. a (key, value) pair): ONE positional
            # submessage, field number = position — repeating the outer
            # field would flatten the pair structure
            sub = bytearray()
            for pos, (item, itp) in enumerate(zip(val, args), start=1):
                _enc_value(sub, pos, item, itp)
            _put_header(buf, field, _WIRE_LEN)
            _put_varint(buf, len(sub))
            buf += sub
            return
        item_tp = args[0] if args else Any
        for item in val:
            _enc_value(buf, field, item, item_tp)
        return
    if origin is dict:
        _kt, vt = get_args(tp) or (str, Any)
        for k in sorted(val):
            entry = bytearray()
            _enc_value(entry, 1, k, str)
            _enc_value(entry, 2, val[k], vt)
            _put_header(buf, field, _WIRE_LEN)
            _put_varint(buf, len(entry))
            buf += entry
        return
    if tp is str and isinstance(val, str):
        raw = val.encode()
        _put_header(buf, field, _WIRE_LEN)
        _put_varint(buf, len(raw))
        buf += raw
        return
    if tp is bytes and isinstance(val, bytes):
        _put_header(buf, field, _WIRE_LEN)
        _put_varint(buf, len(val))
        buf += val
        return
    if tp is bool or (tp is int and isinstance(val, (bool, int))):
        _put_header(buf, field, _WIRE_VARINT)
        _put_varint(buf, _zigzag(int(val)))
        return
    if tp is float and isinstance(val, (int, float)):
        _put_header(buf, field, _WIRE_FIXED64)
        buf += struct.pack("<d", float(val))
        return
    if isinstance(val, (set, frozenset)):
        # no set-typed fields exist in the wire model; fail loudly rather
        # than letting the union fallback stringify it irreversibly
        raise TypeError(f"set-typed field has no wire form: {val!r}")
    # Quantity (str|int|float union), Any, or a value whose runtime type
    # diverges from the hint: the tagged union keeps it lossless
    _enc_union(buf, field, val)


# explicit-empty sentinel for container fields whose default is NON-empty
# (e.g. CRDSpec.versions defaults ["v1"]): proto wire has no native form
# for "present but empty" repeated fields. A 1-byte payload of 0x00 is a
# field-0 header, which real submessages can never start with (field 0 is
# reserved), and k8s strings never contain NUL.
_EMPTY_SENTINEL = b"\x00"


def _enc_message(obj: Any) -> bytearray:
    cls = type(obj)
    buf = bytearray()
    defaults = _DEFAULTS.get(cls)
    if defaults is None:
        _schema(cls)
        defaults = _DEFAULTS[cls]
    for num, name, tp in _schema(cls):
        val = getattr(obj, name)
        if val is None:
            continue
        if name in defaults and val == defaults[name]:
            continue  # omitempty (value == default: decode restores it)
        if isinstance(val, (list, tuple, dict, str, bytes, frozenset)) and not val:
            # empty value. Skipping is only sound when decode's default
            # restores the same empty — i.e. the field HAS a default and
            # it is itself empty. A REQUIRED field (no default) must
            # always hit the wire or cls(**kwargs) fails at decode; a
            # non-empty default (namespace="default",
            # scheduler_name="default-scheduler") makes the emptiness
            # meaningful.
            if name in defaults and not defaults[name]:
                continue
            if isinstance(val, (str, bytes)):
                pass  # zero-length payload decodes back to ""/b""
            else:
                _put_header(buf, num, _WIRE_LEN)
                _put_varint(buf, len(_EMPTY_SENTINEL))
                buf += _EMPTY_SENTINEL
                continue
        _enc_value(buf, num, val, tp)
    return buf


# -- decode ------------------------------------------------------------------


def _dec_union(data: bytes) -> Any:
    i = 0
    val: Any = None
    while i < len(data):
        header, i = _get_varint(data, i)
        field, wire = header >> 3, header & 7
        if wire == _WIRE_LEN:
            ln, i = _get_varint(data, i)
            raw = data[i:i + ln]
            i += ln
            val = raw.decode() if field == 1 else json.loads(raw)
        elif wire == _WIRE_VARINT:
            n, i = _get_varint(data, i)
            val = _unzigzag(n)
        else:
            val = struct.unpack_from("<d", data, i)[0]
            i += 8
    return val


def _dec_value(wire: int, data: bytes, i: int, tp: Any) -> Tuple[Any, int]:
    tp = _resolve_optional(tp)
    origin = get_origin(tp)
    if wire == _WIRE_VARINT:
        n, i = _get_varint(data, i)
        v = _unzigzag(n)
        if tp is bool:
            return bool(v), i
        if tp is float:
            return float(v), i
        return v, i
    if wire == _WIRE_FIXED64:
        return struct.unpack_from("<d", data, i)[0], i + 8
    ln, i = _get_varint(data, i)
    raw = bytes(data[i:i + ln])
    i += ln
    return _dec_single_len(raw, tp)[0], i


def _dec_single_len(raw: bytes, tp: Any) -> Tuple[Any, int]:
    """Decode one length-delimited payload as type tp."""
    tp = _resolve_optional(tp)
    origin = get_origin(tp)
    if dataclasses.is_dataclass(tp) and not origin:
        return _dec_message(raw, tp), len(raw)
    if tp is str:
        return raw.decode(), len(raw)
    if tp is bytes:
        return raw, len(raw)
    if origin is tuple:
        args = get_args(tp)
        if args and Ellipsis not in args:
            # fixed-shape tuple: positional submessage
            out = []
            j = 0
            while j < len(raw):
                h, j = _get_varint(raw, j)
                pos, w = h >> 3, h & 7
                item, j = _dec_value(w, raw, j, args[pos - 1])
                out.append(item)
            return tuple(out), len(raw)
    if origin is dict or origin in (list, tuple) or tp in (Any, object) or origin is typing.Union:
        return _dec_union(raw), len(raw)
    # scalar-union carried payload
    return _dec_union(raw), len(raw)


def _dec_message(data: bytes, cls: type) -> Any:
    fields_by_num = {num: (name, tp) for num, name, tp in _schema(cls)}
    kwargs: Dict[str, Any] = {}
    i = 0
    while i < len(data):
        header, i = _get_varint(data, i)
        num, wire = header >> 3, header & 7
        ent = fields_by_num.get(num)
        if ent is None:
            # unknown field (newer writer): skip by wire type
            if wire == _WIRE_VARINT:
                _n, i = _get_varint(data, i)
            elif wire == _WIRE_FIXED64:
                i += 8
            else:
                ln, i = _get_varint(data, i)
                i += ln
            continue
        name, tp = ent
        rtp = _resolve_optional(tp)
        origin = get_origin(rtp)
        if origin in (list, tuple):
            targs = get_args(rtp)
            if origin is tuple and targs and Ellipsis not in targs:
                # fixed-shape tuple field: one positional submessage
                ln, i = _get_varint(data, i)
                raw = bytes(data[i:i + ln])
                i += ln
                kwargs[name] = _dec_single_len(raw, rtp)[0]
                continue
            (item_tp, *_r) = targs or (Any,)
            item_rtp = _resolve_optional(item_tp)
            if wire == _WIRE_VARINT:
                # int/bool list element rides the varint wire directly
                n, i = _get_varint(data, i)
                item: Any = _unzigzag(n)
                if item_rtp is bool:
                    item = bool(item)
            elif wire == _WIRE_FIXED64:
                item = struct.unpack_from("<d", data, i)[0]
                i += 8
            else:
                ln, i = _get_varint(data, i)
                raw = bytes(data[i:i + ln])
                i += ln
                if raw == _EMPTY_SENTINEL:
                    kwargs.setdefault(name, [])
                    continue
                item = _dec_single_len(raw, item_tp)[0]
            kwargs.setdefault(name, []).append(item)
        elif origin is dict:
            _kt, vt = get_args(rtp) or (str, Any)
            ln, i = _get_varint(data, i)
            raw = bytes(data[i:i + ln])
            i += ln
            if raw == _EMPTY_SENTINEL:
                kwargs.setdefault(name, {})
                continue
            k = val = None
            j = 0
            while j < len(raw):
                eh, j = _get_varint(raw, j)
                enum_, ew = eh >> 3, eh & 7
                if enum_ == 1:
                    k, j = _dec_value(ew, raw, j, str)
                else:
                    val, j = _dec_value(ew, raw, j, vt)
            kwargs.setdefault(name, {})[k] = val
        else:
            kwargs[name], i = _dec_value(wire, data, i, tp)
    # tuplify tuple-typed fields
    for num, name, tp in _schema(cls):
        rtp = _resolve_optional(tp)
        if get_origin(rtp) is tuple and name in kwargs:
            kwargs[name] = tuple(kwargs[name])
    return cls(**kwargs)


# -- envelope (protobuf.go Unknown) ------------------------------------------


def encode_obj(obj: Any, api_version: str = "v1") -> bytes:
    """Typed object -> magic + Unknown{typeMeta{apiVersion,kind}, raw}.

    Unstructured (custom resources) raises TypeError: CRs are JSON-only,
    as in the reference (protobuf is unsupported for CRDs there too)."""
    if isinstance(obj, v1.Unstructured):
        raise TypeError("custom resources have no binary encoding; use JSON")
    kind = type(obj).__name__
    body = _enc_message(obj)
    tm = bytearray()
    _enc_value(tm, 1, api_version, str)
    _enc_value(tm, 2, kind, str)
    env = bytearray()
    _put_header(env, 1, _WIRE_LEN)
    _put_varint(env, len(tm))
    env += tm
    _put_header(env, 2, _WIRE_LEN)
    _put_varint(env, len(body))
    env += body
    return MAGIC + bytes(env)


def decode_obj(data: bytes, cls: Optional[Type] = None) -> Any:
    """magic + Unknown -> typed object. cls overrides the kind lookup."""
    if not data.startswith(MAGIC):
        raise ValueError("missing k8s binary envelope magic")
    data = data[len(MAGIC):]
    i = 0
    kind = ""
    raw = b""
    while i < len(data):
        header, i = _get_varint(data, i)
        num = header >> 3
        ln, i = _get_varint(data, i)
        chunk = bytes(data[i:i + ln])
        i += ln
        if num == 1:
            j = 0
            while j < len(chunk):
                h2, j = _get_varint(chunk, j)
                ln2, j = _get_varint(chunk, j)
                s = chunk[j:j + ln2].decode()
                j += ln2
                if h2 >> 3 == 2:
                    kind = s
        elif num == 2:
            raw = chunk
    if cls is None:
        resource = KIND_TO_RESOURCE.get(kind)
        if resource is None:
            raise KeyError(f"unknown kind {kind!r} in binary envelope")
        cls = RESOURCE_KINDS[resource]
    return _dec_message(raw, cls)
