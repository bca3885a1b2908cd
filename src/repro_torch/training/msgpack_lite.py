"""A small MessagePack codec for the checkpoint format.

The reference writes its checkpoints with the ``msgpack`` package; the
port's machines may not have it, so the port carries this codec for the
subset the format uses: map, array, str, bin, int, float (64-bit), bool
and nil.  ``pack_chunks`` gives, chunk by chunk, the bytes of
``msgpack.packb(obj, use_bin_type=True)`` (the smallest encoding of each
int and length, str as UTF-8 ``str`` types, bytes as ``bin``, tuples and
lists as arrays); large ``bin`` payloads are passed through as they are,
not copied into one buffer.  ``unpackb`` reads them as
``msgpack.unpackb(data, raw=False)`` does (maps as dicts, arrays as
lists).
"""
from __future__ import annotations

import struct
from typing import Any, List

_NIL, _FALSE, _TRUE = b"\xc0", b"\xc2", b"\xc3"


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xFF), (0xcd, ">H", 0xFFFF),
                               (0xce, ">I", 0xFFFFFFFF),
                               (0xcf, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, largest length)) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xd9, ">B", 0xFF), (0xda, ">H", 0xFFFF), (0xdb, ">I", 0xFFFFFFFF))
_BIN = ((0xc4, ">B", 0xFF), (0xc5, ">H", 0xFFFF), (0xc6, ">I", 0xFFFFFFFF))
_ARR = ((0xdc, ">H", 0xFFFF), (0xdd, ">I", 0xFFFFFFFF))
_MAP = ((0xde, ">H", 0xFFFF), (0xdf, ">I", 0xFFFFFFFF))


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(_NIL)
    elif obj is True or obj is False:
        out.append(_TRUE if obj else _FALSE)
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xa0, 32, _STR))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(_header(n, None, 0, _BIN))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, _ARR))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def pack_chunks(obj: Any) -> List:
    """``obj``'s encoding as a list of byte chunks (write them in order)."""
    out: List = []
    _pack(obj, out)
    return out


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xcb: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
                0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
        if c not in lens:
            raise ValueError(f"msgpack type byte {c:#x} is outside the "
                             "checkpoint subset")
        n = self.unpack(lens[c])
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(n), "utf-8")
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(n))
        if c in (0xdc, 0xdd):
            return [self.read() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data) -> Any:
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after the msgpack object")
    return obj
