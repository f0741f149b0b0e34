"""The msgpack subset a flax checkpoint is made of, without msgpack or flax.

The reference writes a checkpoint's payload with
``flax.serialization.to_bytes``: ``msgpack.packb`` of a state-dict (nested
maps with str keys) with ``strict_types=True``, whose array leaves are ext
type 1 holding a second, non-strict ``packb`` of ``(shape, dtype name,
C-order bytes)``. The machine the port runs on has neither package, so this
module writes and reads exactly that subset, byte for byte:

- nil, bool, int, str and bin in msgpack's smallest encodings, arrays
  (a list, or a tuple inside an ext payload) and maps with str keys;
- ext 1 (a numpy array) and ext 3 (a numpy scalar, packed as a 0-d array),
  in fixext or ext 8/16/32 framing;
- flax's chunked form of an array leaf larger than ``MAX_CHUNK_SIZE``
  bytes: a map ``{"__msgpack_chunked_array__": True, "shape": {"0": d0,
  ...}, "chunks": {"0": flat[:n], ...}}``, on both write and read.

Anything else (floats, other ext codes, non-str keys, object dtypes)
raises ``ValueError`` naming it. Decoded arrays are copies, writable, so
``torch.from_numpy`` takes them as they are.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: array leaves above this many bytes are
# split into flat chunks of at most this many
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# --------------------------------------------------------------------------
# write
# --------------------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise ValueError(f"msgpack: integer {n} does not fit 64 bits")


def _header(n: int, fix: int, fix_max: int, w8, w16: int, w32: int) -> bytes:
    """A length header: the fix form, then 8 (where ``w8``), 16, 32 bits."""
    if n <= fix_max:
        return struct.pack("B", fix + n)
    if w8 is not None and n <= 0xFF:
        return struct.pack("BB", w8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", w16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", w32, n)
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 0x1F, 0xD9, 0xDA, 0xDB) + b


def _bin_header(n: int) -> bytes:
    return _header(n, 0, -1, 0xC4, 0xC5, 0xC6)


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return struct.pack("Bb", _FIXEXT[n], code)
    if n <= 0xFF:
        return struct.pack(">BBb", 0xC7, n, code)
    if n <= 0xFFFF:
        return struct.pack(">BHb", 0xC8, n, code)
    return struct.pack(">BIb", 0xC9, n, code)


def _ndarray_parts(arr: np.ndarray, code: int) -> list:
    """An ext record of ``arr``: flax's ``_ndarray_to_bytes`` inside the
    ext framing. The array's bytes go in as a buffer, not a copy: the one
    copy is the caller's final join."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: dtype {arr.dtype} is not serializable")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # (ascontiguousarray would make 0-d 1-d)
    data = memoryview(arr.reshape(-1).view(np.uint8))
    shape = [_int(d) for d in arr.shape]
    inner = [_header(len(shape), 0x90, 0x0F, None, 0xDC, 0xDD), *shape,
             _str(arr.dtype.name), _bin_header(len(data))]
    inner_len = 1 + sum(len(p) for p in inner) + len(data)
    return [_ext_header(code, inner_len), b"\x93", *inner, data]


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a canonical map of flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[o:o + size] for i, o in
                       enumerate(range(0, flat.size, size))}}


def _pack(obj, out: list, in_map: bool) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out += [_bin_header(len(obj)), obj]
    elif type(obj) is list:
        out.append(_header(len(obj), 0x90, 0x0F, None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out, False)
    elif type(obj) is dict:
        out.append(_header(len(obj), 0x80, 0x0F, None, 0xDE, 0xDF))
        for k, v in obj.items():
            if type(k) is not str:
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            out.append(_str(k))
            _pack(v, out, True)
    elif isinstance(obj, np.ndarray):
        if in_map and obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out, True)
        else:
            out += _ndarray_parts(obj, EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        out += _ndarray_parts(np.asarray(obj), EXT_NPSCALAR)
    else:
        raise ValueError(f"msgpack: {type(obj).__name__} is outside the "
                         "subset a checkpoint holds")


def packb(obj) -> bytes:
    """``obj`` (maps with str keys, lists, None, bool, int, str, bytes,
    numpy arrays and scalars) as flax's ``msgpack_serialize`` writes it:
    array leaves of a map larger than ``MAX_CHUNK_SIZE`` bytes in the
    chunked form."""
    out: list = []
    _pack(obj, out, isinstance(obj, dict))
    return b"".join(out)


# --------------------------------------------------------------------------
# read
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack({0xD9: "B", 0xDA: ">H",
                                          0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack: type byte 0x{b:02x} (a float or an "
                         "unused code) is outside the subset a checkpoint "
                         "holds")

    def text(self, n: int, raw: bool):
        b = bytes(self.take(n))
        return b if raw else b.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is outside the "
                             "subset a checkpoint holds")
        inner = _Reader(data)
        shape, name, buf = inner.obj(raw=True)
        if inner.pos != len(data):
            raise ValueError("msgpack: trailing bytes in an array record")
        arr = np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
            shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def _unchunk(d):
    if not isinstance(d, dict):
        return d
    if CHUNKED in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in d.items()}


def unpackb(data) -> object:
    """The object ``packb`` wrote (flax's ``msgpack_restore``): chunked
    array leaves joined back, every array a writable copy."""
    r = _Reader(data)
    out = r.obj(raw=False)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return _unchunk(out)
