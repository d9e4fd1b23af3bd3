"""msgpack codec for the checkpoint payload: the subset of
``flax.serialization`` that the JAX package's checkpoints use, written
here because the port imports neither ``flax`` nor ``msgpack``.

:func:`to_bytes` gives the same bytes as ``flax.serialization.to_bytes``
for the same tree in the same key order (flax packs with
``use_bin_type=True`` and ``strict_types=True``), and
:func:`msgpack_restore` reads what flax writes. The subset:

- maps with str keys (fixmap, map16, map32), in the tree's own key order;
- str (fixstr, str8/16/32) and bin (bin8/16/32);
- arrays (fixarray, array16, array32) from lists (a tuple raises, as under
  flax's ``strict_types``); an ndarray's header is one;
- ints, non-negative and negative, each in the shortest encoding;
- numpy arrays as ext type 1: ``packb((shape, dtype.name,
  arr.tobytes("C")))``, so a tensor's memory format (channels_last) never
  reaches the bytes; numpy scalars as flax's ext type 3 (the same body).
  msgpack takes fixext1/2/4/8/16 when the ext data is exactly 1, 2, 4, 8
  or 16 bytes long and ext8/16/32 otherwise.

Anything else (floats, bools, nil, flax's complex ext type 2, arrays over
flax's 2**30-byte chunk size, dtypes numpy cannot name) raises
:class:`MsgpackError` rather than being guessed at.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax splits larger arrays into chunk maps; no train state comes near it
MAX_CHUNK_SIZE = 2**30


class MsgpackError(ValueError):
    """The bytes or the tree are outside the codec's subset, or malformed."""


# -- encode --------------------------------------------------------------

def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif v >= 0:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(struct.pack("B", tag) + struct.pack(fmt, v))
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")
    elif v >= -32:
        out.append(struct.pack("b", v))
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(struct.pack("B", tag) + struct.pack(fmt, v))
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")


def _header(n: int, fix: int, fix_max: int, tags, out: List[bytes]) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``tags`` ((tag, struct format, limit), ...) whose limit holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for tag, fmt, lim in tags:
        if n < lim:
            out.append(struct.pack("B", tag) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} does not fit 32 bits")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    _header(len(b), 0xA0, 32, _STR, out)
    out.append(b)


def _ndarray_body(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)``
    packed as a fixarray of three."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError(f"dtype {arr.dtype} is not serializable")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise MsgpackError(
            f"array of {arr.nbytes} bytes: flax would chunk it (outside the "
            "subset)"
        )
    out: List[bytes] = [b"\x93"]
    _header(arr.ndim, 0x90, 16, _ARRAY, out)
    for d in arr.shape:
        _int(int(d), out)
    _str(arr.dtype.name, out)
    data = arr.tobytes("C")
    _header(len(data), None, 0, _BIN, out)
    out.append(data)
    return b"".join(out)


def _ext(code: int, data: bytes, out: List[bytes]) -> None:
    if len(data) in _FIXEXT:
        out.append(struct.pack("BB", _FIXEXT[len(data)], code))
    else:
        _header(len(data), None, 0, _EXT, out)
        out.append(struct.pack("B", code))
    out.append(data)


def _pack(x: Any, out: List[bytes]) -> None:
    if isinstance(x, dict):
        _header(len(x), 0x80, 16, _MAP, out)
        for k, v in x.items():
            if type(k) is not str:
                raise MsgpackError(f"map key {k!r} is not a str")
            _str(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _ext(EXT_NDARRAY, _ndarray_body(x), out)
    elif isinstance(x, np.generic):
        _ext(EXT_NPSCALAR, _ndarray_body(np.asarray(x)), out)
    elif type(x) is list:  # a tuple is not: flax packs with strict_types
        _header(len(x), 0x90, 16, _ARRAY, out)
        for v in x:
            _pack(v, out)
    elif type(x) is str:
        _str(x, out)
    elif type(x) is bytes:
        _header(len(x), None, 0, _BIN, out)
        out.append(x)
    elif type(x) is int:
        _int(x, out)
    else:
        raise MsgpackError(
            f"{type(x).__name__} is outside the checkpoint codec's subset"
        )


def to_bytes(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` (nested dicts with str keys and numpy
    leaves), byte for byte what ``flax.serialization.to_bytes`` writes for
    the same tree in the same key order."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


# -- decode --------------------------------------------------------------

_INT_FMT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR_LEN = {tag: fmt for tag, fmt, _ in _STR}
_BIN_LEN = {tag: fmt for tag, fmt, _ in _BIN}
_ARRAY_LEN = {tag: fmt for tag, fmt, _ in _ARRAY}
_MAP_LEN = {tag: fmt for tag, fmt, _ in _MAP}
_FIXEXT_LEN = {tag: n for n, tag in _FIXEXT.items()}
_EXT_LEN = {tag: fmt for tag, fmt, _ in _EXT}

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(
                f"truncated: {n} bytes wanted at offset {self.pos} of "
                f"{len(self.buf)}"
            )
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader) -> Any:
    tag = r.unpack("B")
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _read_map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_read(r) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return _utf8(r.take(tag & 0x1F))
    if tag in _INT_FMT:
        return r.unpack(_INT_FMT[tag])
    if tag in _STR_LEN:
        return _utf8(r.take(r.unpack(_STR_LEN[tag])))
    if tag in _BIN_LEN:
        return bytes(r.take(r.unpack(_BIN_LEN[tag])))
    if tag in _ARRAY_LEN:
        return [_read(r) for _ in range(r.unpack(_ARRAY_LEN[tag]))]
    if tag in _MAP_LEN:
        return _read_map(r, r.unpack(_MAP_LEN[tag]))
    if tag in _FIXEXT_LEN:
        return _read_ext(r, _FIXEXT_LEN[tag])
    if tag in _EXT_LEN:
        return _read_ext(r, r.unpack(_EXT_LEN[tag]))
    raise MsgpackError(
        f"msgpack type byte {tag:#04x} at offset {r.pos - 1} is outside the "
        "checkpoint codec's subset"
    )


def _utf8(view: memoryview) -> str:
    try:
        return bytes(view).decode("utf-8")
    except UnicodeDecodeError as e:
        raise MsgpackError(f"str is not utf-8: {e}") from e


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if type(k) is not str:
            raise MsgpackError(f"map key {k!r} is not a str")
        out[k] = _read(r)
    return out


def _read_ext(r: _Reader, n: int):
    code = r.unpack("B")
    data = r.take(n)
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(
            f"msgpack ext type {code} is outside the checkpoint codec's "
            "subset"
        )
    inner = _Reader(data)
    if inner.unpack("B") != 0x93:
        raise MsgpackError("ndarray ext body is not a 3-array")
    shape, name = _read(inner), _read(inner)
    bin_len = _BIN_LEN.get(inner.unpack("B"))
    if bin_len is None:
        raise MsgpackError("ndarray ext body has no bin payload")
    buf = inner.take(inner.unpack(bin_len))
    if (inner.pos != len(data) or type(name) is not str
            or not isinstance(shape, list)
            or not all(type(d) is int and d >= 0 for d in shape)):
        raise MsgpackError("malformed ndarray ext body")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"dtype {name!r} is not a numpy dtype") from e
    count = int(np.prod(shape, dtype=np.int64))
    if len(buf) != count * dtype.itemsize:
        raise MsgpackError(
            f"ndarray ext body holds {len(buf)} bytes for shape {shape} "
            f"{dtype}"
        )
    arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def msgpack_restore(payload) -> Any:
    """The tree that ``payload`` encodes: nested dicts, numpy arrays (views
    of one writable copy of ``payload``), numpy scalars, str and int."""
    r = _Reader(bytearray(payload))
    tree = _read(r)
    if r.pos != len(r.buf):
        raise MsgpackError(
            f"{len(r.buf) - r.pos} trailing bytes after the payload's tree"
        )
    return tree
