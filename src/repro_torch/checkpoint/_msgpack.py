"""A msgpack codec for checkpoint manifests.

Covers the subset a manifest uses: nil, bool, int (-2^63 .. 2^64 - 1),
float (as float64), str, array (lists and tuples) and map (dict, in its
iteration order).  :func:`packb` chooses the shortest encoding of each
value, as ``msgpack.packb`` does with its defaults, so the two give the
same bytes for the same manifest (``tests/test_torch_stream_parts.py``)
and the reference's checkpoints and the port's read each other.
:func:`unpackb` also reads bin and float32 values; it returns lists for
arrays and str for strings.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]


def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} is too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} is too small for msgpack")


def _header(n: int, fix: int, fix_max: int, c16: int, c32: int,
            c8: int = 0) -> bytes:
    if n <= fix_max:
        return struct.pack("B", fix | n)
    if c8 and n < (1 << 8):
        return struct.pack(">BB", c8, n)
    if n < (1 << 16):
        return struct.pack(">BH", c16, n)
    if n < (1 << 32):
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack cannot hold {n} items or bytes")


def _pack(v: Any, out: List[bytes]) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True:
        out.append(b"\xc3")
    elif v is False:
        out.append(b"\xc2")
    elif type(v) is int:
        _int(v, out)
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        data = v.encode("utf-8")
        out.append(_header(len(data), 0xA0, 31, 0xDA, 0xDB, c8=0xD9))
        out.append(data)
    elif type(v) in (list, tuple):
        out.append(_header(len(v), 0x90, 15, 0xDC, 0xDD))
        for item in v:
            _pack(item, out)
    elif type(v) is dict:
        out.append(_header(len(v), 0x80, 15, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(key, out)
            _pack(item, out)
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def packb(value: Any) -> bytes:
    """``value`` as msgpack bytes."""
    out: List[bytes] = []
    _pack(value, out)
    return b"".join(out)


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    code = data[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        return _str(data, pos, code & 0x1F)
    if 0x90 <= code <= 0x9F:
        return _array(data, pos, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _map(data, pos, code & 0x0F)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if code in fixed:
        return fixed[code], pos
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if code in scalars:
        fmt = scalars[code]
        (v,) = struct.unpack_from(fmt, data, pos)
        return v, pos + struct.calcsize(fmt)
    lengths = {0xD9: (">B", _str), 0xDA: (">H", _str), 0xDB: (">I", _str),
               0xC4: (">B", _bin), 0xC5: (">H", _bin), 0xC6: (">I", _bin),
               0xDC: (">H", _array), 0xDD: (">I", _array),
               0xDE: (">H", _map), 0xDF: (">I", _map)}
    if code in lengths:
        fmt, read = lengths[code]
        (n,) = struct.unpack_from(fmt, data, pos)
        return read(data, pos + struct.calcsize(fmt), n)
    raise ValueError(f"msgpack type 0x{code:02x} is not supported")


def _str(data: bytes, pos: int, n: int) -> Tuple[str, int]:
    return data[pos:pos + n].decode("utf-8"), pos + n


def _bin(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    return bytes(data[pos:pos + n]), pos + n


def _array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(data, pos)
        out[key], pos = _unpack(data, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """The value of one msgpack object (the whole of ``data``)."""
    value, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} extra bytes after the msgpack "
                         f"object")
    return value
