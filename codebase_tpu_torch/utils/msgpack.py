"""A msgpack codec for checkpoints, byte for byte the format flax writes.

The subset of the msgpack spec (github.com/msgpack/msgpack/blob/master/spec.md)
that flax's `serialization.msgpack_serialize` / `msgpack_restore` use:
nil, bool, int of every width, float64 (float32 on read), str, bin, array,
map and ext, with flax's ext types for arrays:

- type 1, an array: the packed triple `(shape, dtype name, C-order bytes)`;
- type 3, a numpy scalar: the same triple with shape `()`, read back as a
  scalar;
- type 2, a Python complex, `(real, imag)`, read only.

`serialize` also does what `msgpack_serialize` does around the packer:
every map's keys in sorted order (flax copies the tree with
`jax.tree_util.tree_map`, which sorts dict keys) and every array above
`MAX_CHUNK_SIZE` bytes inside a map in flax's chunked form, a map of
`__msgpack_chunked_array__`, `shape` and `chunks` (keys "0", "1", ...).
`deserialize` joins chunked arrays back.

Array leaves are numpy arrays or torch tensors (moved to the host one at a
time as they are packed). bfloat16, which numpy lacks, is written under its
dtype name "bfloat16" as raw 2-byte words (a torch.bfloat16 tensor viewed
as int16) and read back as a torch.bfloat16 tensor; every other dtype reads
back as a numpy array. Large payloads are not copied element by element:
`serialize_pieces` returns the encoded stream as a list of byte strings and
memoryviews of the arrays' own buffers, which a writer joins or writes out
one after another.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # bytes; flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ arrays


def _host_array(x):
    """(numpy array of the bytes to write, dtype name) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).cpu().numpy(), "bfloat16"
        x = x.cpu().numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        x = x.copy(order="C")
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return x, x.dtype.name


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's `_chunk`: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i : i + size] for i in range(0, n, size)]
    return {
        CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _prepare(tree, chunk=True):
    """The tree as flax packs it: maps with sorted keys; large arrays at the
    top or in maps (not in lists, which flax's chunking does not enter)
    chunked."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k], chunk) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v, False) for v in tree)
    if chunk and _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


# ------------------------------------------------------------------ packer


def _pack_uint(n: int, out: list) -> None:
    if n < 0x80:
        out.append(struct.pack(">B", n))
    elif n < 0x100:
        out.append(struct.pack(">BB", 0xCC, n))
    elif n < 0x10000:
        out.append(struct.pack(">BH", 0xCD, n))
    elif n < 0x100000000:
        out.append(struct.pack(">BI", 0xCE, n))
    elif n < 0x10000000000000000:
        out.append(struct.pack(">BQ", 0xCF, n))
    else:
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _pack_int(n: int, out: list) -> None:
    if n >= 0:
        _pack_uint(n, out)
    elif n >= -32:
        out.append(struct.pack(">b", n))
    elif n >= -(1 << 7):
        out.append(struct.pack(">Bb", 0xD0, n))
    elif n >= -(1 << 15):
        out.append(struct.pack(">Bh", 0xD1, n))
    elif n >= -(1 << 31):
        out.append(struct.pack(">Bi", 0xD2, n))
    elif n >= -(1 << 63):
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _header(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below `fix_max`, else the first of the
    (code, limit, struct format) forms that holds n."""
    if n < fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, limit, fmt in codes:
        if n < limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} is too large for msgpack")


_STR = ((0xD9, 1 << 8, "B"), (0xDA, 1 << 16, "H"), (0xDB, 1 << 32, "I"))
_ARRAY = ((0xDC, 1 << 16, "H"), (0xDD, 1 << 32, "I"))
_MAP = ((0xDE, 1 << 16, "H"), (0xDF, 1 << 32, "I"))
_BIN = ((0xC4, 1 << 8, "B"), (0xC5, 1 << 16, "H"), (0xC6, 1 << 32, "I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, 1 << 8, "B"), (0xC8, 1 << 16, "H"), (0xC9, 1 << 32, "I"))


def _pack_str(s: str, out: list) -> None:
    data = s.encode("utf-8")
    _header(len(data), 0xA0, 32, _STR, out)
    out.append(data)


def _pack_bin(data, n: int, out: list) -> None:
    _header(n, 0, 0, _BIN, out)
    out.append(data)


def _pack_ext(code: int, pieces: list, out: list) -> None:
    n = sum(len(p) for p in pieces)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    else:
        for marker, limit, fmt in _EXT:
            if n < limit:
                out.append(struct.pack(">B" + fmt + "b", marker, n, code))
                break
        else:
            raise ValueError(f"ext payload of {n} bytes is too large for msgpack")
    out.extend(pieces)


def _array_pieces(x) -> list:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, bytes))."""
    arr, name = _host_array(x)
    out = [b"\x93"]  # a fixarray of 3
    _header(arr.ndim, 0x90, 16, _ARRAY, out)
    for d in arr.shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    data = memoryview(arr.reshape(-1).view(np.uint8))
    _pack_bin(data, data.nbytes, out)
    return out


def _pack(obj, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        _pack_str(obj, out)
    elif t is bytes or t is bytearray:
        _pack_bin(bytes(obj), len(obj), out)
    elif t is dict:
        _header(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        _header(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_pieces(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_pieces(np.asarray(obj)), out)
    else:
        # strict types, as flax packs: a tuple or a subclass is not a list
        raise TypeError(f"can not serialize {t.__name__!r} object")


def serialize_pieces(tree) -> list:
    """The encoded stream of `tree` as a list of bytes-like pieces."""
    out: list = []
    _pack(_prepare(tree), out)
    return out


def serialize(tree) -> bytes:
    """`flax.serialization.msgpack_serialize(tree)`'s bytes."""
    return b"".join(serialize_pieces(tree))


# ---------------------------------------------------------------- unpacker


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw
        num, ext = self.num, self.ext
        # type byte -> reader, for every form outside the fix ranges
        self.forms = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(num("B"))),
            0xC5: lambda: bytes(self.take(num("H"))),
            0xC6: lambda: bytes(self.take(num("I"))),
            0xC7: lambda: ext(num("B")), 0xC8: lambda: ext(num("H")), 0xC9: lambda: ext(num("I")),
            0xCA: lambda: num("f"), 0xCB: lambda: num("d"),
            0xCC: lambda: num("B"), 0xCD: lambda: num("H"), 0xCE: lambda: num("I"), 0xCF: lambda: num("Q"),
            0xD0: lambda: num("b"), 0xD1: lambda: num("h"), 0xD2: lambda: num("i"), 0xD3: lambda: num("q"),
            0xD4: lambda: ext(1), 0xD5: lambda: ext(2), 0xD6: lambda: ext(4), 0xD7: lambda: ext(8),
            0xD8: lambda: ext(16),
            0xD9: lambda: self.str_(num("B")), 0xDA: lambda: self.str_(num("H")), 0xDB: lambda: self.str_(num("I")),
            0xDC: lambda: self.array(num("H")), 0xDD: lambda: self.array(num("I")),
            0xDE: lambda: self.map_(num("H")), 0xDF: lambda: self.map_(num("I")),
        }

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def str_(self, n: int):
        data = self.take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def ext(self, n: int):
        code = self.num("b")
        return _ext_value(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return self.str_(b & 0x1F)
        if b not in self.forms:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        return self.forms[b]()


def _array_from_bytes(data: memoryview):
    """flax's `_ndarray_from_bytes`; bfloat16 as a torch tensor."""
    r = _Reader(data, raw=True)
    length = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
    if r.num("B") != 0x93:
        raise ValueError("ndarray ext payload is not a (shape, dtype, bytes) triple")
    shape, name = r.value(), r.value().decode()
    fmt = length.get(r.num("B"))
    if fmt is None:
        raise ValueError("ndarray ext payload without a bin body")
    buf = r.take(r.num(fmt))
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).copy().reshape(shape)
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).copy().reshape(shape)


def _ext_value(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == EXT_NPSCALAR:
        arr = _array_from_bytes(data)
        return arr[()]
    if code == EXT_COMPLEX:
        re, im = _Reader(data).value()
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    """flax's `_unchunk_array_leaves_in_place`."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def deserialize(data):
    """`flax.serialization.msgpack_restore`: the tree of `data` (bytes-like),
    with chunked arrays joined."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the msgpack value")
    return _unchunk(tree)
