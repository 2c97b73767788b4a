"""AMF0 encoding/decoding (the RTMP command-message payload format).
(the port's copy of ``mixlab_tpu/io_host/rtmp/amf0.py``)

The reference gets AMF0 from the rml_rtmp crate; here it is implemented
directly (Adobe AMF0 spec): number, boolean, string, object, null,
undefined, ECMA array, strict array, long string.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

NUMBER = 0x00
BOOLEAN = 0x01
STRING = 0x02
OBJECT = 0x03
NULL = 0x05
UNDEFINED = 0x06
ECMA_ARRAY = 0x08
OBJECT_END = 0x09
STRICT_ARRAY = 0x0A
LONG_STRING = 0x0C


class Amf0Error(Exception):
    pass


def encode(value: Any) -> bytes:
    if value is None:
        return bytes([NULL])
    if isinstance(value, bool):
        return bytes([BOOLEAN, 1 if value else 0])
    if isinstance(value, (int, float)):
        return bytes([NUMBER]) + struct.pack(">d", float(value))
    if isinstance(value, str):
        data = value.encode("utf-8")
        if len(data) < 0x10000:
            return bytes([STRING]) + struct.pack(">H", len(data)) + data
        return bytes([LONG_STRING]) + struct.pack(">I", len(data)) + data
    if isinstance(value, dict):
        out = bytearray([OBJECT])
        for k, v in value.items():
            kb = str(k).encode("utf-8")
            out += struct.pack(">H", len(kb)) + kb
            out += encode(v)
        out += struct.pack(">H", 0) + bytes([OBJECT_END])
        return bytes(out)
    if isinstance(value, (list, tuple)):
        out = bytearray([STRICT_ARRAY]) + struct.pack(">I", len(value))
        for v in value:
            out += encode(v)
        return bytes(out)
    raise Amf0Error(f"cannot encode {type(value)!r}")


def encode_all(*values: Any) -> bytes:
    return b"".join(encode(v) for v in values)


# AMF0 arrives straight off the RTMP socket (command messages from
# arbitrary publishers); every read is bounds-checked and every failure
# is the typed Amf0Error — never struct.error / IndexError /
# UnicodeDecodeError / RecursionError (tools/deepfuzz.py found all four
# leaking from the unchecked version).
_MAX_DEPTH = 32


def _need(data: bytes, pos: int, n: int):
    if pos + n > len(data):
        raise Amf0Error(f"truncated AMF0 data at {pos} (need {n} bytes)")


def _utf8(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise Amf0Error(f"invalid utf-8 in AMF0 string: {e}") from None


def _decode_one(data: bytes, pos: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise Amf0Error("AMF0 nesting too deep")
    _need(data, pos, 1)
    marker = data[pos]
    pos += 1
    if marker == NUMBER:
        _need(data, pos, 8)
        (v,) = struct.unpack_from(">d", data, pos)
        return v, pos + 8
    if marker == BOOLEAN:
        _need(data, pos, 1)
        return bool(data[pos]), pos + 1
    if marker == STRING:
        _need(data, pos, 2)
        (n,) = struct.unpack_from(">H", data, pos)
        pos += 2
        _need(data, pos, n)
        return _utf8(data[pos : pos + n]), pos + n
    if marker == LONG_STRING:
        _need(data, pos, 4)
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        _need(data, pos, n)
        return _utf8(data[pos : pos + n]), pos + n
    if marker in (NULL, UNDEFINED):
        return None, pos
    if marker in (OBJECT, ECMA_ARRAY):
        if marker == ECMA_ARRAY:
            _need(data, pos, 4)
            pos += 4  # approximate count, ignore
        obj = {}
        while True:
            _need(data, pos, 2)
            (n,) = struct.unpack_from(">H", data, pos)
            pos += 2
            if n == 0:
                _need(data, pos, 1)
                if data[pos] == OBJECT_END:
                    return obj, pos + 1
            _need(data, pos, n)
            key = _utf8(data[pos : pos + n])
            pos += n
            val, pos = _decode_one(data, pos, depth + 1)
            obj[key] = val
    if marker == STRICT_ARRAY:
        _need(data, pos, 4)
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        arr = []
        for _ in range(n):
            v, pos = _decode_one(data, pos, depth + 1)
            arr.append(v)
        return arr, pos
    raise Amf0Error(f"unknown AMF0 marker 0x{marker:02x} at {pos - 1}")


def decode_all(data: bytes) -> List[Any]:
    values = []
    pos = 0
    while pos < len(data):
        v, pos = _decode_one(data, pos)
        values.append(v)
    return values
