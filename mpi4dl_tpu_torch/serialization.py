"""Flax's msgpack checkpoint format, without ``msgpack`` or ``flax``.

The JAX package writes checkpoints with ``flax.serialization``
(``to_bytes`` / ``msgpack_restore``). This module reads and writes the same
bytes for the subset a checkpoint uses, so the port's checkpoints and the
JAX package's are interchangeable and the card needs neither package:

- msgpack as ``msgpack.packb(..., use_bin_type=True)`` writes it: str-keyed
  maps, str, bin, ext, ints (smallest encoding), 64-bit floats, nil, bool,
  arrays (lists and tuples);
- ext code 1 is an ndarray, its payload ``packb((shape, dtype name,
  C-order bytes))``; ext code 3 a numpy scalar (the same payload, 0-d);
- a dict value (or the root) that is an array of more than
  :data:`MAX_CHUNK_SIZE` bytes is written as ``{"__msgpack_chunked_array__":
  True, "shape": {"0": ...}, "chunks": {"0": ...}}`` of its flattened
  pieces, as flax does.

Leaves on writing: numpy arrays and scalars, and torch tensors (any device;
written in their logical C order, never their storage order). On reading,
arrays are numpy, except ``"bfloat16"``, which numpy does not know without
``ml_dtypes``: those come back as ``torch.bfloat16`` tensors from the raw
bytes. Lists and tuples of the flax layout are already ``{"0": ...}`` maps;
the callers (``weights``, ``checkpoint``) build and read those.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 - 1 bytes a leaf.
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# -- writing -----------------------------------------------------------------

def _header(n: int, fix: int | None, fix_limit: int, codes: tuple[int, ...]) -> bytes:
    """A length header: the fix form below ``fix_limit``, else 8/16/32-bit
    length codes (``codes``; 8-bit may be missing: ``None``)."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    c8, c16, c32 = codes
    if c8 is not None and n < 0x100:
        return bytes([c8, n])
    if n < 0x10000:
        return struct.pack(">BH", c16, n)
    if n < 0x100000000:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
            if v <= top:
                return struct.pack(fmt, code, v)
    else:
        for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                               (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -2**63)):
            if v >= low:
                return struct.pack(fmt, code, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    return _header(n, None, 0, (0xC7, 0xC8, 0xC9)) + struct.pack(">b", code)


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _raw(v):
    """(shape, dtype name, C-order bytes as a buffer) of an array leaf."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(v)
        name = a.dtype.name
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serializable")
    return tuple(int(d) for d in v.shape), name, a.reshape(-1).view(np.uint8)


def _array_payload(v) -> list:
    shape, name, data = _raw(v)
    parts = [b"\x93"]  # a 3-array: (shape, dtype name, bytes)
    _pack(list(shape), parts)
    _pack(name, parts)
    parts += [_header(data.nbytes, None, 0, (0xC4, 0xC5, 0xC6)), memoryview(data)]
    return parts


def _chunk(v) -> dict:
    """flax's ``_chunk``: the flattened array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = v.element_size() if isinstance(v, torch.Tensor) else v.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = v.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(v.shape)},
            "chunks": {str(k): flat[i:i + size] for k, i in enumerate(range(0, n, size))}}


def _oversized(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size() > MAX_CHUNK_SIZE
    return isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE


def _pack(v, out: list) -> None:
    t = type(v)
    if v is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if v else b"\xc2")
    elif t is int:
        out.append(_pack_int(v))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, v))
    elif t is str:
        b = v.encode("utf-8")
        out += [_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)), b]
    elif t in (bytes, bytearray, memoryview):
        out += [_header(memoryview(v).nbytes, None, 0, (0xC4, 0xC5, 0xC6)), v]
    elif t is dict:
        out.append(_header(len(v), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, item in v.items():
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {k!r}")
            _pack(k, out)
            _pack(item, out)
    elif t in (list, tuple):
        out.append(_header(len(v), 0x90, 16, (None, 0xDC, 0xDD)))
        for item in v:
            _pack(item, out)
    elif _is_array(v) or isinstance(v, np.generic):
        code = EXT_NPSCALAR if isinstance(v, np.generic) else EXT_NDARRAY
        payload = _array_payload(np.asarray(v) if isinstance(v, np.generic) else v)
        out.append(_ext_header(sum(memoryview(p).nbytes for p in payload), code))
        out += payload
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def _chunked(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy of the dicts:
    oversized arrays that are dict values (or the root) become chunk maps."""
    if type(tree) is dict:
        return {k: (_chunk(v) if _oversized(v) else _chunked(v) if type(v) is dict else v)
                for k, v in tree.items()}
    return _chunk(tree) if _oversized(tree) else tree


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` with flax's ext hook."""
    parts: list = []
    _pack(obj, parts)
    return b"".join(parts)


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: :func:`packb` after
    chunking oversized arrays."""
    return packb(_chunked(tree))


def dump(tree, f) -> int:
    """Write :func:`msgpack_serialize`'s bytes to the binary file ``f``
    without joining them first; returns the bytes written."""
    parts: list = []
    _pack(_chunked(tree), parts)
    n = 0
    for p in parts:
        n += f.write(p)
    return n


# -- reading -----------------------------------------------------------------

_FIXED = {  # code -> (struct format, size) of a scalar's value
    0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
    0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """A msgpack decoder over one buffer. ``bin`` values come back as
    memoryviews of it inside array payloads (zero copy) and as ``bytes``
    elsewhere."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def _len(self, size: int) -> int:
        return struct.unpack(_LEN[size], self._take(size))[0]

    def read(self, view: bool = False):
        c = self._take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F, view)
        if 0xA0 <= c <= 0xBF:
            return str(self._take(c & 0x1F), "utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            data = self._take(self._len({0xC4: 1, 0xC5: 2, 0xC6: 4}[c]))
            return data if view else bytes(data)
        if c in (0xC7, 0xC8, 0xC9):
            n = self._len({0xC7: 1, 0xC8: 2, 0xC9: 4}[c])
            return self._ext(n)
        if c in _FIXED:
            fmt, size = _FIXED[c]
            return struct.unpack(fmt, self._take(size))[0]
        if 0xD4 <= c <= 0xD8:
            return self._ext(1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self._take(self._len({0xD9: 1, 0xDA: 2, 0xDB: 4}[c])), "utf-8")
        if c in (0xDC, 0xDD):
            return self._array(self._len(2 if c == 0xDC else 4), view)
        if c in (0xDE, 0xDF):
            return self._map(self._len(2 if c == 0xDE else 4))
        raise ValueError(f"msgpack code 0x{c:02x} is not supported")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _array(self, n: int, view: bool) -> list:
        return [self.read(view) for _ in range(n)]

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext code {code} is not an ndarray or a numpy scalar")
        shape, name, data = self.read(view=True)
        if self.pos != end:
            raise ValueError("malformed ndarray ext payload")
        a = _array_from(tuple(shape), name, data)
        return a[()] if code == EXT_NPSCALAR else a


def _array_from(shape, name: str, data: memoryview):
    if name == "bfloat16":
        if len(data) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        if data.readonly:
            data = bytearray(data)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunked(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if type(tree) is dict:
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def unpackb(data):
    """Decode one msgpack object (``msgpack.unpackb(data, raw=False)`` with
    flax's ext hook). Arrays share ``data``'s memory: pass a ``bytearray``
    for writable ones."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return out


def msgpack_restore(data):
    """``flax.serialization.msgpack_restore``: :func:`unpackb`, chunked
    arrays joined."""
    return _unchunked(unpackb(data))


def load(path: str):
    """:func:`msgpack_restore` of a file, read into one writable buffer."""
    import os

    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)
