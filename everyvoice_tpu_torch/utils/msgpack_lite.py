"""A small pure-Python MessagePack codec for EVTP checkpoint bodies.

The JAX package writes checkpoint bodies with ``flax.serialization`` on top
of the ``msgpack`` package; machines that run the port may have neither.
This codec covers what those bodies hold: nil, booleans, integers, floats,
strings, binary, arrays, maps and flax's extension types

- ext 1 (ndarray): payload = msgpack ``(shape, dtype_name, C-order bytes)``,
  as ``flax.serialization._ndarray_to_bytes`` writes it;
- ext 3 (numpy scalar): the same payload for a 0-d array.

Numbers are packed in the smallest form, as ``msgpack.packb`` does, so the
encoder's output for a tree of dicts, strings and arrays is byte-identical
to flax's. ``bfloat16`` arrays, which numpy lacks, decode to float32.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------- encoding
def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix_base, fix_max, codes) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
    out += struct.pack(">b", code)
    out += payload


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf8")
        _pack_len(len(data), out, 0xA0, 31, ((0xD9, ">B", 0xFF),
                                             (0xDA, ">H", 0xFFFF),
                                             (0xDB, ">I", 0xFFFFFFFF)))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, ((0xC4, ">B", 0xFF),
                                            (0xC5, ">H", 0xFFFF),
                                            (0xC6, ">I", 0xFFFFFFFF)))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                            (0xDD, ">I", 0xFFFFFFFF)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                            (0xDF, ">I", 0xFFFFFFFF)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------- decoding
def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos : self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf8")

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.string(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False):
    """Decode one msgpack object; ``raw`` keeps strings as bytes."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
