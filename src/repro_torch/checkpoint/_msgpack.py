"""A small MessagePack codec for checkpoint manifests.

The subset a manifest uses: map, array, str, bin, int (to 64 bits), float
(read as 32 or 64 bit, written as 64), bool and nil. Each value is written
in the smallest form, as ``msgpack.packb`` writes it (``use_bin_type``),
so a manifest's bytes are those of the JAX package's, and each reads the
other's. Extension types are refused.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb"]


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[int, int, int] | tuple[int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    widths = (">B", ">H", ">I")[-len(codes):]
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        _pack_int(int(obj), out)
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCB)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too large for msgpack")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} too small for msgpack")


# --------------------------------------------------------------------------
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
        0xDC: ">H", 0xDD: ">I",                  # array
        0xDE: ">H", 0xDF: ">I"}                  # map


def unpackb(data: bytes):
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} extra bytes after the object")
    return obj


def _take(buf, pos: int, fmt: str):
    n = struct.calcsize(fmt)
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return struct.unpack_from(fmt, buf, pos)[0], pos + n


def _unpack(buf, pos: int):
    if pos >= len(buf):
        raise ValueError("truncated msgpack data")
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(buf, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        return _take(buf, pos, _FIXED[b])
    if b in _LEN:
        n, pos = _take(buf, pos, _LEN[b])
        if b in (0xD9, 0xDA, 0xDB):
            return _str(buf, pos, n)
        if b in (0xC4, 0xC5, 0xC6):
            if pos + n > len(buf):
                raise ValueError("truncated msgpack data")
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xDC, 0xDD):
            return _array(buf, pos, n)
        return _map(buf, pos, n)
    raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                     f"manifest subset")


def _str(buf, pos: int, n: int):
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        x, pos = _unpack(buf, pos)
        out.append(x)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
