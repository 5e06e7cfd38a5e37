"""A reader of the msgpack files that ``flax.serialization.msgpack_serialize``
writes, in pure Python and numpy: the JAX package's checkpoints
(``mgvae_tpu/utils/checkpoint.py``) without flax or msgpack.

It reads the subset flax writes: maps, arrays, str, bin, ints, floats, nil
and bool, and flax's two extension types for numpy values
(``flax/serialization.py``, ``_MsgpackExtType``): 1, an ndarray, and 3, a
numpy scalar, each a nested msgpack array (shape, dtype name, the
row-major bytes). Leaves past flax's 2**30 bytes, which it writes as
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
are joined back into one array, as ``msgpack_restore`` does. Anything else
(another extension type, a map key that is not a string, trailing or
missing bytes) raises ValueError. A bfloat16 leaf (numpy has no such dtype)
comes back as a float32 array of the same values: a bf16 number is the top
half of its float32. The result is what ``flax.serialization.msgpack_restore``
returns: dicts, lists, Python scalars, numpy arrays and numpy scalars.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


def read(path: str):
    """The decoded tree of a msgpack file."""
    with open(path, "rb") as f:
        return loads(f.read())


def loads(data: bytes):
    """The decoded tree of one msgpack value that fills ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the first value")
    return _unchunk(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated (needs {end} bytes, has {len(self.data)})")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:                          # positive fixint
            return b
        if b >= 0xE0:                          # negative fixint
            return b - 0x100
        if b <= 0x8F:                          # fixmap
            return self.map(b & 0x0F)
        if b <= 0x9F:                          # fixarray
            return self.array(b & 0x0F)
        if b <= 0xBF:                          # fixstr
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:                  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:                  # ext 8 / 16 / 32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:                  # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                  # int 8 / 16 / 32 / 64
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:                  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                  # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                  # array 16 / 32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):                  # map 16 / 32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: type byte 0x{b:02x} at offset {self.pos - 1} is not used")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: a str that is not UTF-8 ({e})") from e

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: a map key of type {type(k).__name__}")
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = int.from_bytes(self.take(1), "big", signed=True)
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: extension type {code} is not one of flax's numpy types "
                         f"({EXT_NDARRAY} ndarray, {EXT_NPSCALAR} numpy scalar)")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack (shape, dtype name, row-major bytes)."""
    r = _Reader(data)
    tpl = r.value()
    if r.pos != len(data) or not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("msgpack: an ndarray extension that is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    name = name.decode() if isinstance(name, bytes) else name
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)
            and isinstance(name, str) and isinstance(buf, bytes)):
        raise ValueError("msgpack: an ndarray extension that is not (shape, dtype, bytes)")
    if name == "bfloat16":
        dtype, out = np.dtype("<u2"), np.float32
    else:
        try:
            dtype = out = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"msgpack: an ndarray of unknown dtype {name!r}") from e
        if dtype.hasobject:
            raise ValueError(f"msgpack: an ndarray of object dtype {name!r}")
    count = int(np.prod(shape, dtype=np.int64))
    if len(buf) != count * dtype.itemsize:
        raise ValueError(f"msgpack: an ndarray of shape {shape} and dtype {name} with "
                         f"{len(buf)} bytes")
    flat = np.frombuffer(buf, dtype=dtype)
    if out is np.float32:       # bfloat16: the top 16 bits of a float32
        return (flat.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return flat.reshape(shape).copy()


def _unchunk(tree):
    """flax's chunked leaves joined back into arrays, anywhere in the tree."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            try:
                shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
                chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
                return np.concatenate(chunks).reshape(shape)
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"msgpack: a malformed chunked array ({e})") from e
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree
