"""Minimal ONNX protobuf wire-format encode/decode (no onnx dependency);
the reference's ``paddle_tpu/onnx/_proto.py`` as it is.

Reference parity target: ``python/paddle/onnx/export.py`` (paddle2onnx).
This environment ships no ``onnx`` package, so the exporter writes the wire
format directly — only the message fields the exporter emits, from the
public onnx.proto3 schema.  The decoder exists so tests can round-trip and
execute exported graphs without external tooling.

Wire format: each field is (field_number << 3 | wire_type) varint, then a
varint (type 0), 64-bit (1), length-delimited bytes (2), or 32-bit (5).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

# onnx.TensorProto data types (public enum)
FLOAT, INT32, INT64, BOOL = 1, 6, 7, 9

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS = 6, 7


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def f_str(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def f_msg(field: int, encoded: bytes) -> bytes:
    return f_bytes(field, encoded)


def f_packed_ints(field: int, values) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return f_bytes(field, payload)


def f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# decoder (generic: returns {field_number: [values]} per message)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode(buf: bytes) -> Dict[int, List[Union[int, bytes, float]]]:
    """One pass over a message; length-delimited fields stay as bytes (the
    caller decodes nested messages / strings / packed arrays knowingly)."""
    out: Dict[int, List] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError("unsupported wire type %d" % wire)
        out.setdefault(field, []).append(v)
    return out


def decode_packed_ints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out
