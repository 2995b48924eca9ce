"""The msgpack subset that flax checkpoints use, in pure Python (the port's
own codec: the machine with the card has no ``msgpack`` package).

`to_bytes` encodes and `msgpack_restore` decodes exactly what
``flax.serialization.to_bytes`` / ``msgpack_restore`` write and read for a
state dict:

- maps with str keys, str, bin, int, float (float 64 written, 32 and 64
  read), bool, nil and arrays (decoded as lists);
- ext type 1, an ndarray: its payload is itself msgpack of ``(shape,
  dtype name, C-order bytes)``;
- ext type 3, a numpy scalar, read only (decoded as a 0-d array's item).

The encoder picks the smallest format for each value, as msgpack's packer
does, so a tree of these types encodes to the bytes flax writes.

Refused with `MsgpackError` rather than misread: flax's chunked-array
marker (``__msgpack_chunked_array__``, written only for a leaf above 2**30
bytes), ext type 2 (a complex number), any other ext type or format byte,
a ``bfloat16`` leaf (the port's saved state is float32 throughout),
truncated input and trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
CHUNKED_MARKER = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes this codec does not read, or a value it does not write."""


# -- encoder --------------------------------------------------------------


def _pack_int(out: list, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -32 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0 <= x <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", x))
    elif 0 <= x <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", x))
    elif -0x80 <= x < 0:
        out.append(b"\xd0" + struct.pack(">b", x))
    elif -0x8000 <= x < 0:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif -0x80000000 <= x < 0:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif -0x8000000000000000 <= x < 0:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise MsgpackError(f"integer {x} does not fit in 64 bits")


def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes``; 0 where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise MsgpackError(f"object of {n} entries or bytes is too large")


def _pack_str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _pack_bin(out: list, b: bytes) -> None:
    _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(b)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise MsgpackError(f"cannot encode an array of dtype {a.dtype}")
    if a.dtype.name == "bfloat16":
        raise MsgpackError("bfloat16 leaves are not written by the port")
    return to_bytes((a.shape, a.dtype.name,
                     np.ascontiguousarray(a).tobytes()))


def _pack(out: list, x: Any) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        _pack_str(out, x)
    elif t is bytes:
        _pack_bin(out, x)
    elif t in (list, tuple):
        _pack_len(out, len(x), 0x90, 16, (0, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(x), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in x.items():
            if type(k) is not str:
                raise MsgpackError(f"map key {k!r} is not a str")
            _pack_str(out, k)
            _pack(out, v)
    elif t is np.ndarray:
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    else:
        raise MsgpackError(f"cannot encode a {t.__name__} ({x!r:.60})")


def to_bytes(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` (dicts with str keys, lists, tuples, str,
    bytes, int, float, bool, None and numpy arrays)."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


# -- decoder --------------------------------------------------------------

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
#: fixed-size numbers: format byte → struct format.
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
#: sized objects (bin, ext, str, array, map): format byte → length format.
_SIZED = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xC7: "B", 0xC8: ">H",
          0xC9: ">I", 0xD9: "B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
          0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.at = 0
        self.raw = raw  # str as bytes (flax reads its ndarray header so)

    def take(self, n: int) -> memoryview:
        end = self.at + n
        if end > len(self.buf):
            raise MsgpackError(
                f"truncated msgpack: {n} bytes wanted at offset {self.at} "
                f"of {len(self.buf)}")
        out = self.buf[self.at:end]
        self.at = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            raise MsgpackError("ext type 2 (complex) is not read by the port")
        raise MsgpackError(f"unknown msgpack ext type {code}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if CHUNKED_MARKER in out:
            raise MsgpackError(
                "flax's chunked-array layout (a leaf above 2**30 bytes) is "
                "not read by the port")
        return out

    def value(self):
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _NUMBERS:
            return self.unpack(_NUMBERS[c])
        if c in _SIZED:
            n = self.unpack(_SIZED[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            return self.array(n) if c <= 0xDD else self.map(n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        raise MsgpackError(f"unknown msgpack format byte 0x{c:02x}")


def _unpack_all(data: bytes, raw: bool):
    r = _Reader(data, raw)
    out = r.value()
    if r.at != len(r.buf):
        raise MsgpackError(
            f"{len(r.buf) - r.at} trailing bytes after the msgpack object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    header = _unpack_all(data, raw=True)
    if not (isinstance(header, list) and len(header) == 3
            and isinstance(header[0], list) and isinstance(header[1], bytes)
            and isinstance(header[2], bytes)):
        raise MsgpackError("an ndarray ext payload is (shape, dtype, bytes)")
    shape, name, buf = header
    if name == b"bfloat16":
        raise MsgpackError("bfloat16 leaves are not read by the port")
    try:
        dtype = np.dtype(name.decode())
    except TypeError as e:
        raise MsgpackError(f"unknown array dtype {name!r}") from e
    try:
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    except ValueError as e:
        raise MsgpackError(f"array bytes do not fill shape {shape}") from e


def msgpack_restore(data: bytes) -> Any:
    """The tree ``data`` encodes (arrays as read-only numpy arrays)."""
    return _unpack_all(bytes(data), raw=False)
