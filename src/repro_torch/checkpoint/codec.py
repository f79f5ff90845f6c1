"""The part of MessagePack that checkpoints use: one map of str to bin.

``packb`` gives the bytes of ``msgpack.packb(mapping, use_bin_type=True)``
for a mapping of ``str`` to ``bytes`` (the smallest map, str and bin
headers, big-endian lengths), and ``unpackb`` reads such a map back as
``msgpack.unpackb(..., raw=False)`` does.  Any other type raises.  The
port carries this codec so that it needs no ``msgpack`` package.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """The header of a length-``n`` item: the fix form up to ``fix_max``,
    then the 8-, 16- and 32-bit length forms ``codes`` offers."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} exceeds 2**32 - 1")


def packb(mapping: dict) -> bytes:
    out = [_header(len(mapping), 0x80, 15, (None, 0xDE, 0xDF))]
    for key, value in mapping.items():
        if not isinstance(key, str) or not isinstance(value, (bytes, bytearray)):
            raise TypeError("msgpack: only a map of str to bytes is supported")
        k = key.encode("utf-8")
        out += [_header(len(k), 0xA0, 31, (0xD9, 0xDA, 0xDB)), k,
                _header(len(value), None, 0, (0xC4, 0xC5, 0xC6)), bytes(value)]
    return b"".join(out)


def _length(buf, pos: int, code: int, fix_base: int | None, fix_mask: int,
            wide: dict) -> tuple[int, int]:
    if fix_base is not None and code & ~fix_mask & 0xFF == fix_base:
        return code & fix_mask, pos
    if code not in wide:
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")
    fmt = wide[code]
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


_MAP = {0xDE: ">H", 0xDF: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}


def unpackb(data: bytes) -> dict:
    buf = memoryview(data)
    n, pos = _length(buf, 1, buf[0], 0x80, 0x0F, _MAP)
    out = {}
    for _ in range(n):
        klen, pos = _length(buf, pos + 1, buf[pos], 0xA0, 0x1F, _STR)
        key = bytes(buf[pos:pos + klen]).decode("utf-8")
        pos += klen
        vlen, pos = _length(buf, pos + 1, buf[pos], None, 0, _BIN)
        out[key] = bytes(buf[pos:pos + vlen])
        pos += vlen
    if pos != len(buf):
        raise ValueError("msgpack: trailing bytes after the map")
    return out
