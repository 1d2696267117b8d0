"""Read the `.msgpack` files the JAX package writes, without msgpack or flax.

The JAX package checkpoints a whole `TrainState` with flax's
`serialization.to_bytes` (its train/checkpoint.py): the state's state dict
(nested maps with str keys: "params", "batch_stats", "opt_state",
"step"; tuples and namedtuples as maps keyed "0", "1", ... or by field)
packed by msgpack, with arrays as msgpack extension types. `loads`
decodes such bytes into nested dicts of numpy arrays, as flax's
`msgpack_restore` does; `load` reads a file.

The subset of msgpack it reads is what flax emits: maps, arrays (as
lists), str, bin (as bytes), ints, floats, nil, bools, and the ext and
fixext headers carrying flax's three extension types:

* 1, an ndarray: a packed [shape, dtype name, C-order bytes];
* 2, a Python complex: a packed [real, imag];
* 3, a numpy scalar: an ndarray of shape (), returned as a numpy scalar;

and flax's `__msgpack_chunked_array__` maps, which split an array of more
than 2**30 bytes into flat chunks; they are joined back into one array.
Any other extension type raises. A bfloat16 array is returned as float32
(exact: a bfloat16 is the upper half of a float32); numpy has no bfloat16.
Arrays are copies, writable.
"""

from __future__ import annotations

import struct

import numpy as np

NDARRAY, COMPLEX, NPSCALAR = 1, 2, 3  # flax's _MsgpackExtType
CHUNKED = "__msgpack_chunked_array__"

# Fixed-width headers: byte -> (struct format of the value, its size).
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8),
            0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# Headers with a length field: byte -> (kind, struct format of the length).
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes, ext):
        self.data, self.pos, self.ext = memoryview(data), 0, ext

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b", 1)
            return self.ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "ext":
                code = self.unpack(">b", 1)
                return self.ext(code, bytes(self.take(n)))
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack header 0x{b:02x} is not one flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _no_ext(code, data):
    raise ValueError(f"an extension type ({code}) inside an array's header")


def _unpack(data: bytes, ext=_no_ext):
    reader = _Reader(data, ext)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = _unpack(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.dtype("<u2")).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == NDARRAY:
        return _ndarray(data)
    if code == COMPLEX:
        real, imag = _unpack(data)
        return complex(real, imag)
    if code == NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _unchunk(tree):
    """Join flax's chunked arrays back into arrays, recursively."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes):
    """The tree flax's `msgpack_restore` returns for `data`: nested dicts
    (and lists) of numpy arrays, numpy scalars and Python values."""
    return _unchunk(_unpack(data, _ext))


def load(path: str):
    """`loads` of a file's bytes."""
    with open(path, "rb") as f:
        return loads(f.read())
