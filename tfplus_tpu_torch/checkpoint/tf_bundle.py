"""TensorFlow's TensorBundle checkpoint format (checkpoint V2), read and
written without TensorFlow and without protobuf.

What ``tf.train.load_checkpoint`` reads and ``tf.raw_ops.SaveV2`` writes
(tensorflow/core/util/tensor_bundle/tensor_bundle.cc):

    <prefix>.index                  a LevelDB-layout table (uncompressed
                                    blocks of at most 256 KiB, a restart
                                    every 16 entries, block CRC32Cs, a
                                    48-byte footer): key "" holds the
                                    BundleHeaderProto, each tensor name,
                                    in bytewise order, its BundleEntryProto
    <prefix>.data-0000i-of-0000N    raw little-endian tensor bytes, in the
                                    order the tensors were written

Each entry gives the tensor's dtype, shape, data shard, offset and size and
the masked CRC32C of its bytes. A string tensor's bytes are its lengths as
varint64s, a masked CRC32C of those lengths (each taken as a uint32), then
the strings. A tensor saved in slices (a TF1 partitioned variable) has an
entry with its full shape and the slices' extents; each slice's bytes sit
under a key of their own (``\\x00`` + OrderedCode of the name and extents).

:class:`TFBundleReader` reads every bundle of that layout: several data
shards (``MergeV2Checkpoints``), sliced tensors (assembled on read), every
numeric dtype, bfloat16 and strings; every tensor's CRC32C is checked on
read and a mismatch raises with the tensor's name and the prefix.
:class:`TFBundleWriter` and :func:`write_bundle` write one data shard the
way ``SaveV2`` does, byte for byte: the same ``.index`` and ``.data`` files
for the same names and arrays in the same order.

bfloat16 has no numpy type here: a bfloat16 tensor reads as 2-byte void
(:data:`BFLOAT16`, ``'V2'``), the raw bits, as
:class:`~tfplus_tpu_torch.checkpoint.bundle.BundleReader` reads one the JAX
package wrote (``arr.view(np.uint16)`` gives the bits; in torch,
``torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)``). The writer
takes such arrays, ml_dtypes ``bfloat16`` arrays and ``torch.bfloat16``
tensors. String tensors read as numpy object arrays of ``bytes``, as
TensorFlow gives them.

Prefixes are local paths, as for TensorFlow's own calls here: a
``scheme://`` prefix raises ``ValueError``. Reads go by offset into the data
file (``numpy.fromfile``); writes stream tensor by tensor, so neither holds
a whole data file in memory.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import crc32c

MAGIC = 0xDB4775248B80FB57          # LevelDB table magic (kTableMagicNumber)
BLOCK_SIZE = 262144                 # TF's table::Options defaults
RESTART_INTERVAL = 16
_FOOTER = 48                        # two block handles padded to 40, magic
_TYPE_NONE = 0                      # block compression byte: none

# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_STRING, DT_COMPLEX64, DT_INT64, DT_BOOL = 7, 8, 9, 10
DT_BFLOAT16, DT_UINT16, DT_COMPLEX128, DT_HALF = 14, 17, 18, 19
DT_UINT32, DT_UINT64 = 22, 23

BFLOAT16 = np.dtype("V2")

_NP_OF_DT = {
    DT_FLOAT: np.dtype(np.float32), DT_DOUBLE: np.dtype(np.float64),
    DT_INT32: np.dtype(np.int32), DT_UINT8: np.dtype(np.uint8),
    DT_INT16: np.dtype(np.int16), DT_INT8: np.dtype(np.int8),
    DT_STRING: np.dtype(object), DT_COMPLEX64: np.dtype(np.complex64),
    DT_INT64: np.dtype(np.int64), DT_BOOL: np.dtype(np.bool_),
    DT_BFLOAT16: BFLOAT16, DT_UINT16: np.dtype(np.uint16),
    DT_COMPLEX128: np.dtype(np.complex128), DT_HALF: np.dtype(np.float16),
    DT_UINT32: np.dtype(np.uint32), DT_UINT64: np.dtype(np.uint64),
}
_DT_OF_NP = {v: k for k, v in _NP_OF_DT.items() if k != DT_STRING}


def data_filename(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def index_filename(prefix: str) -> str:
    return prefix + ".index"


def _local(prefix) -> str:
    prefix = os.fspath(prefix)
    if "://" in prefix:
        raise ValueError(
            f"a TensorBundle prefix must be a local path, got "
            f"{prefix.split('://')[0]}:// ({prefix!r}); write locally and "
            "copy, or use the native bundle (checkpoint.save)")
    return prefix


def _latest(directory: str) -> str:
    """The prefix a ``checkpoint`` state file in ``directory`` names, as
    ``tf.train.load_checkpoint`` resolves a directory."""
    state = os.path.join(directory, "checkpoint")
    if not os.path.exists(state):
        raise ValueError(f"no 'checkpoint' file or checkpoints in "
                         f"{directory!r}")
    with open(state, encoding="utf-8") as f:
        m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                      f.read(), re.M)
    if m is None:
        raise ValueError(f"{state}: no model_checkpoint_path")
    path = m.group(1).encode().decode("unicode_escape")
    return path if os.path.isabs(path) else os.path.join(directory, path)


# ---------------------------------------------------------------------------
# protobuf wire format, by hand
# ---------------------------------------------------------------------------

def _put_varint(out: bytearray, v: int):
    v &= (1 << 64) - 1
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf, i: int) -> Tuple[int, int]:
    r = s = 0
    while True:
        if i >= len(buf) or s > 63:
            raise ValueError("bad varint in a TensorBundle index")
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if b < 0x80:
            return r, i
        s += 7


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf) -> Iterator[Tuple[int, object]]:
    """``(field number, value)`` of a serialized message: an int for the
    varint and fixed wire types, a bytes slice for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _get_varint(buf, i)
        f, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _get_varint(buf, i)
        elif wt in (1, 5):
            w = 8 if wt == 1 else 4
            v = int.from_bytes(buf[i:i + w], "little")
            i += w
        elif wt == 2:
            ln, i = _get_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        if i > n:
            raise ValueError("truncated protobuf message")
        yield f, v


def _put_field(out: bytearray, field: int, wire: int):
    _put_varint(out, (field << 3) | wire)


class Entry:
    """A BundleEntryProto: ``dtype`` (TF enum), ``shape``, ``shard_id``,
    ``offset``, ``size``, ``crc32c`` (masked) and ``slices`` (each a tuple
    of ``(start, length)`` per dim, length -1 for the whole dim)."""
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c",
                 "slices")

    def __init__(self, dtype=0, shape=(), shard_id=0, offset=0, size=0,
                 crc32c=0, slices=()):
        self.dtype, self.shape, self.shard_id = dtype, tuple(shape), shard_id
        self.offset, self.size, self.crc32c = offset, size, crc32c
        self.slices = list(slices)

    @classmethod
    def parse(cls, buf) -> "Entry":
        e = cls()
        for f, v in _fields(buf):
            if f == 1:
                e.dtype = v
            elif f == 2:
                e.shape = _parse_shape(v)
            elif f == 3:
                e.shard_id = v
            elif f == 4:
                e.offset = _int64(v)
            elif f == 5:
                e.size = _int64(v)
            elif f == 6:
                e.crc32c = v
            elif f == 7:
                e.slices.append(_parse_slice(v))
        return e

    def serialize(self) -> bytes:
        """The bytes TF's ``SerializeAsString`` gives: fields in number
        order, zeros left out (proto3), the shape always present."""
        out = bytearray()
        _put_field(out, 1, 0)
        _put_varint(out, self.dtype)
        shape = bytearray()
        for d in self.shape:
            dim = bytearray()
            if d:
                _put_field(dim, 1, 0)
                _put_varint(dim, d)
            _put_field(shape, 2, 2)
            _put_varint(shape, len(dim))
            shape += dim
        _put_field(out, 2, 2)
        _put_varint(out, len(shape))
        out += shape
        for field, v in ((3, self.shard_id), (4, self.offset),
                         (5, self.size)):
            if v:
                _put_field(out, field, 0)
                _put_varint(out, v)
        if self.crc32c:
            _put_field(out, 6, 5)
            out += int(self.crc32c).to_bytes(4, "little")
        if self.slices:
            raise ValueError("the writer writes no sliced entries")
        return bytes(out)


def _parse_shape(buf) -> Tuple[int, ...]:
    dims = []
    for f, v in _fields(buf):
        if f == 2:
            size = 0
            for g, w in _fields(v):
                if g == 1:
                    size = _int64(w)
            dims.append(size)
        elif f == 3 and v:
            raise ValueError("a TensorBundle entry of unknown rank")
    return tuple(dims)


def _parse_slice(buf) -> Tuple[Tuple[int, int], ...]:
    extents = []
    for f, v in _fields(buf):
        if f == 1:
            start, length = 0, -1
            for g, w in _fields(v):
                if g == 1:
                    start = _int64(w)
                elif g == 2:
                    length = _int64(w)
            extents.append((start, length))
    return tuple(extents)


def _header(num_shards: int = 1) -> bytes:
    """BundleHeaderProto{num_shards, endianness LITTLE (the default, left
    out), version{producer 1}}."""
    out = bytearray()
    _put_field(out, 1, 0)
    _put_varint(out, num_shards)
    _put_field(out, 3, 2)
    out += b"\x02\x08\x01"
    return bytes(out)


def _parse_header(buf) -> Tuple[int, bool]:
    """``(num_shards, big_endian)``."""
    num_shards, big = 1, False
    for f, v in _fields(buf):
        if f == 1:
            num_shards = v
        elif f == 2:
            big = v == 1
    return num_shards, big


# ---------------------------------------------------------------------------
# OrderedCode of a slice's key (tensorflow/core/lib/strings/ordered_code.cc)
# ---------------------------------------------------------------------------

_SIGNED_HEADER = {1: (0x80, 0), 2: (0xC0, 0), 3: (0xE0, 0), 4: (0xF0, 0),
                  5: (0xF8, 0), 6: (0xFC, 0), 7: (0xFE, 0), 8: (0xFF, 0),
                  9: (0xFF, 0x80), 10: (0xFF, 0xC0)}


def _signed(k: bytes, i: int) -> Tuple[int, int]:
    """``WriteSignedNumIncreasing``'s number at ``k[i:]``: the length is
    the run of leading bits equal to the first (ones for a number >= 0),
    the header XORed over a big-endian two's complement."""
    first = k[i] >> 7
    bits = (k[i] << 8) | (k[i + 1] if i + 1 < len(k) else (0 if first
                                                           else 0xFF))
    n = 0
    while n < 16 and ((bits >> (15 - n)) & 1) == first:
        n += 1
    if n not in _SIGNED_HEADER or i + n > len(k):
        raise ValueError(f"bad slice key {k!r}")
    raw = bytearray(k[i:i + n])
    h0, h1 = _SIGNED_HEADER[n]
    raw[0] ^= h0
    if n > 1:
        raw[1] ^= h1
    return int.from_bytes(raw, "big", signed=True), i + n


def _slice_key(k: bytes) -> Tuple[str, Tuple[Tuple[int, int], ...]]:
    """``(name, extents)`` of a slice's key: ``NumIncreasing(0)``, the
    escaped name, ``NumIncreasing(dims)``, then start and length of each
    dim as signed numbers."""
    i, name = 1, bytearray()
    while True:
        b, nxt = k[i], k[i + 1]
        if b == 0x00 and nxt == 0x01:         # terminator
            i += 2
            break
        if b == 0x00 and nxt == 0xFF:         # escaped 0x00
            name.append(0x00)
            i += 2
        elif b == 0xFF and nxt == 0x00:       # escaped 0xff
            name.append(0xFF)
            i += 2
        elif b in (0x00, 0xFF):
            raise ValueError(f"bad slice key {k!r}")
        else:
            name.append(b)
            i += 1
    n = k[i]
    dims = int.from_bytes(k[i + 1:i + 1 + n], "big")
    i += 1 + n
    extents = []
    for _ in range(dims):
        start, i = _signed(k, i)
        length, i = _signed(k, i)
        extents.append((start, length))
    return name.decode("utf-8", "surrogateescape"), tuple(extents)


# ---------------------------------------------------------------------------
# the LevelDB table layout of the .index file
# ---------------------------------------------------------------------------

def _block_crc(contents, kind: int) -> int:
    return crc32c.mask(crc32c.extend(crc32c.value(contents), bytes([kind])))


def _read_block(data: bytes, handle: Tuple[int, int], path: str) -> bytes:
    off, size = handle
    if off + size + 5 > len(data):
        raise IOError(f"{path}: a table block runs past the end of the file")
    contents = data[off:off + size]
    kind = data[off + size]
    stored = int.from_bytes(data[off + size + 1:off + size + 5], "little")
    if _block_crc(contents, kind) != stored:
        raise IOError(f"{path}: checksum mismatch in the table block at "
                      f"offset {off}")
    if kind != _TYPE_NONE:
        raise ValueError(f"{path}: table block at offset {off} has "
                         f"compression type {kind}; only uncompressed "
                         "blocks (type 0) are read")
    return contents


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    num_restarts = int.from_bytes(block[-4:], "little")
    limit = len(block) - 4 - 4 * num_restarts
    if limit < 0:
        raise ValueError("bad restart array in a table block")
    i, key = 0, b""
    while i < limit:
        shared, i = _get_varint(block, i)
        unshared, i = _get_varint(block, i)
        vlen, i = _get_varint(block, i)
        key = key[:shared] + block[i:i + unshared]
        i += unshared
        yield key, block[i:i + vlen]
        i += vlen


def _handle(buf, i: int = 0) -> Tuple[Tuple[int, int], int]:
    off, i = _get_varint(buf, i)
    size, i = _get_varint(buf, i)
    return (off, size), i


def _put_handle(out: bytearray, handle: Tuple[int, int]):
    _put_varint(out, handle[0])
    _put_varint(out, handle[1])


def read_table(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Every ``(key, value)`` of a LevelDB-layout table file, in order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER or int.from_bytes(data[-8:], "little") != MAGIC:
        raise ValueError(f"{path}: not a TensorBundle index (bad footer)")
    footer = data[-_FOOTER:]
    _, i = _handle(footer)                     # the (empty) meta-index
    index_handle, _ = _handle(footer, i)
    for _, value in _block_entries(_read_block(data, index_handle, path)):
        yield from _block_entries(_read_block(data, _handle(value)[0], path))


def _shortest_separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's ``FindShortestSeparator`` for the bytewise comparator."""
    n = min(len(start), len(limit))
    i = 0
    while i < n and start[i] == limit[i]:
        i += 1
    if i < n:
        b = start[i]
        if b < 0xFF and b + 1 < limit[i]:
            return start[:i] + bytes([b + 1])
    return start


def _short_successor(key: bytes) -> bytes:
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


class _BlockBuilder:
    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.reset()

    def reset(self):
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last = b""

    def empty(self) -> bool:
        return not self.buf

    def add(self, key: bytes, value: bytes):
        shared = 0
        if self.counter < self.interval:
            n = min(len(self.last), len(key))
            while shared < n and self.last[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        _put_varint(self.buf, shared)
        _put_varint(self.buf, len(key) - shared)
        _put_varint(self.buf, len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last = key
        self.counter += 1

    def size_estimate(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        out = bytes(self.buf) + b"".join(
            r.to_bytes(4, "little") for r in self.restarts) + \
            len(self.restarts).to_bytes(4, "little")
        return out


def build_table(items: Iterable[Tuple[bytes, bytes]]) -> bytes:
    """A LevelDB-layout table of ``items`` (keys in increasing bytewise
    order), as TF's ``table::TableBuilder`` writes it with no compression:
    the same bytes."""
    out = bytearray()
    data, index = _BlockBuilder(RESTART_INTERVAL), _BlockBuilder(1)
    pending: Optional[Tuple[int, int]] = None
    last = b""

    def write_block(contents: bytes) -> Tuple[int, int]:
        handle = (len(out), len(contents))
        out.extend(contents)
        out.append(_TYPE_NONE)
        out.extend(_block_crc(contents, _TYPE_NONE).to_bytes(4, "little"))
        return handle

    def index_entry(key: bytes, handle):
        v = bytearray()
        _put_handle(v, handle)
        index.add(key, bytes(v))

    for key, value in items:
        if pending is not None:
            index_entry(_shortest_separator(last, key), pending)
            pending = None
        data.add(key, value)
        last = key
        if data.size_estimate() >= BLOCK_SIZE:
            pending = write_block(data.finish())
            data.reset()
    if not data.empty():
        pending = write_block(data.finish())
    meta = write_block(_BlockBuilder(RESTART_INTERVAL).finish())
    if pending is not None:
        index_entry(_short_successor(last), pending)
    index_handle = write_block(index.finish())
    footer = bytearray()
    _put_handle(footer, meta)
    _put_handle(footer, index_handle)
    footer += bytes(_FOOTER - 8 - len(footer))
    footer += MAGIC.to_bytes(8, "little")
    out += footer
    return bytes(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def numpy_dtype(dt: int, name: str = "") -> np.dtype:
    """The numpy dtype a TF ``DataType`` reads as."""
    if dt not in _NP_OF_DT:
        raise ValueError(f"{name}: TensorFlow DataType {dt} is not read "
                         "(numeric, bool, bfloat16 and string tensors are)")
    return _NP_OF_DT[dt]


class TFBundleReader:
    """A TensorBundle opened for reading: the names, shapes and dtypes from
    the ``.index`` and any tensor by offset from its data shard.
    ``prefix`` may also be a directory with a ``checkpoint`` state file,
    whose newest checkpoint is opened."""

    def __init__(self, prefix):
        prefix = _local(prefix)
        if os.path.isdir(prefix):
            prefix = _latest(prefix)
        self.prefix = prefix
        index = index_filename(prefix)
        if not os.path.exists(index):
            raise FileNotFoundError(f"no TensorBundle at {prefix!r} "
                                    f"({index} does not exist)")
        self._entries: Dict[str, Entry] = {}
        self._slices: Dict[Tuple[str, tuple], Entry] = {}
        header = None
        for key, value in read_table(index):
            if not key:
                header = _parse_header(value)
            elif key[:1] == b"\x00":
                self._slices[_slice_key(key)] = Entry.parse(value)
            else:
                self._entries[key.decode("utf-8", "surrogateescape")] = \
                    Entry.parse(value)
        if header is None:
            raise ValueError(f"{index}: no bundle header")
        self.num_shards, self.big_endian = header

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {n: list(e.shape) for n, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> Dict[str, np.dtype]:
        return {n: numpy_dtype(e.dtype, n) for n, e in self._entries.items()}

    def has_tensor(self, name: str) -> bool:
        return name in self._entries

    def entry(self, name: str) -> Entry:
        if name not in self._entries:
            raise KeyError(f"no tensor {name!r} in the TensorBundle at "
                           f"{self.prefix!r}")
        return self._entries[name]

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entry(name)
        if not e.slices:
            return self._read(name, e)
        dt = numpy_dtype(e.dtype, name)
        full = (np.full(e.shape, b"", dtype=object) if dt == object
                else np.zeros(e.shape, dt))
        for extents in e.slices:
            part = self._slices.get((name, extents))
            if part is None:
                raise ValueError(f"{name}: slice {extents} missing from the "
                                 f"TensorBundle at {self.prefix!r}")
            if len(extents) != len(e.shape):
                raise ValueError(f"{name}: slice {extents} has another rank "
                                 f"than {e.shape}")
            at = tuple(slice(s, s + n) if n >= 0 else slice(None)
                       for s, n in extents)
            full[at] = self._read(name, part)
        return full

    def _read(self, name: str, e: Entry) -> np.ndarray:
        dt = numpy_dtype(e.dtype, name)
        path = data_filename(self.prefix, e.shard_id, self.num_shards)
        count = int(np.prod(e.shape, dtype=np.int64))
        if dt != object and e.size != count * dt.itemsize:
            raise ValueError(f"{name}: the entry gives {e.size} bytes, its "
                             f"shape {list(e.shape)} {count * dt.itemsize}")
        raw = np.fromfile(path, dtype=np.uint8, count=e.size, offset=e.offset)
        if raw.size != e.size:
            raise IOError(f"{name}: truncated read from {path}")
        if dt == object:
            arr = _strings(name, raw, count, e.crc32c, self.prefix)
        else:
            if crc32c.mask(crc32c.value(raw)) != e.crc32c:
                raise IOError(f"{name}: checksum mismatch in {path} (the "
                              f"TensorBundle at {self.prefix!r})")
            arr = self._typed(raw, dt)
        return arr.reshape(e.shape)

    def _typed(self, raw: np.ndarray, dt: np.dtype) -> np.ndarray:
        if dt == BFLOAT16:
            if self.big_endian:
                return raw.view(">u2").astype("<u2").view(BFLOAT16)
            return raw.view(BFLOAT16)
        arr = raw.view(dt.newbyteorder(">" if self.big_endian else "<"))
        return arr if arr.dtype.isnative else arr.astype(dt)


def _strings(name, raw: np.ndarray, count: int, stored: int,
             prefix: str) -> np.ndarray:
    """A DT_STRING tensor's bytes: ``count`` varint64 lengths, the masked
    CRC32C of the lengths (each as a uint32, or uint64 past 2^32 - 1), then
    the strings. The entry's checksum covers the lengths' words, their
    checksum and the strings."""
    buf = raw.tobytes()
    lengths, i = [], 0
    for _ in range(count):
        n, i = _get_varint(buf, i)
        lengths.append(n)
    words = b"".join(n.to_bytes(4 if n <= 0xFFFFFFFF else 8, "little")
                     for n in lengths)
    crc = crc32c.value(words)
    got = buf[i:i + 4]
    if len(got) != 4 or int.from_bytes(got, "little") != crc32c.mask(crc):
        raise IOError(f"{name}: checksum mismatch in the string lengths "
                      f"(the TensorBundle at {prefix!r})")
    i += 4
    crc = crc32c.extend(crc32c.extend(crc, got), raw[i:])
    if crc32c.mask(crc) != stored:
        raise IOError(f"{name}: checksum mismatch (the TensorBundle at "
                      f"{prefix!r})")
    out = np.empty((count,), dtype=object)
    for j, n in enumerate(lengths):
        out[j] = buf[i:i + n]
        i += n
    if i != len(buf):
        raise IOError(f"{name}: string lengths do not cover its bytes")
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BFLOAT16)
        return t.numpy()
    return np.asarray(a)


def _dt_of(arr: np.ndarray, name: str) -> int:
    dt = arr.dtype
    if dt.kind in "OSU":
        return DT_STRING
    if dt == BFLOAT16 or dt.name == "bfloat16":
        return DT_BFLOAT16
    key = dt.newbyteorder("=") if dt.byteorder in "<>" else dt
    if key not in _DT_OF_NP:
        raise ValueError(f"{name}: no TensorFlow DataType for {dt}")
    return _DT_OF_NP[key]


def _little_endian_bytes(arr: np.ndarray, dt: int) -> np.ndarray:
    """The array's bytes as little-endian uint8, without a copy where they
    already are."""
    arr = np.ascontiguousarray(arr)
    if dt == DT_BFLOAT16:
        arr = arr.view(np.uint16)
    if arr.dtype.byteorder == ">" or (arr.dtype.byteorder == "="
                                      and np.little_endian is False):
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr.reshape(-1).view(np.uint8)


def _string_bytes(arr: np.ndarray):
    items = [x.encode("utf-8") if isinstance(x, str) else bytes(x)
             for x in arr.reshape(-1).tolist()]
    lengths = bytearray()
    for s in items:
        _put_varint(lengths, len(s))
    words = b"".join(len(s).to_bytes(4 if len(s) <= 0xFFFFFFFF else 8,
                                     "little") for s in items)
    crc = crc32c.value(words)
    check = crc32c.mask(crc).to_bytes(4, "little")
    crc = crc32c.extend(crc, check)
    for s in items:
        crc = crc32c.extend(crc, s)
    return [bytes(lengths), check] + items, crc


class TFBundleWriter:
    """Writes one data shard and the index, as ``SaveV2``: :meth:`add` each
    tensor in turn (its bytes go to the data file at once), then
    :meth:`finish`. Files are written under temporary names and renamed into
    place by :meth:`finish`; a writer left unfinished removes them."""

    def __init__(self, prefix):
        self.prefix = _local(prefix)
        d = os.path.dirname(self.prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        self._data = data_filename(self.prefix, 0, 1)
        self._tmp = f"{self._data}.tempstate{os.getpid()}"
        self._f = open(self._tmp, "wb")
        self._entries: Dict[bytes, Entry] = {}
        self._offset = 0

    def add(self, name: str, array):
        key = name.encode("utf-8", "surrogateescape")
        if not key or key[:1] == b"\x00":
            raise ValueError(f"bad tensor name {name!r}")
        if key in self._entries:
            raise ValueError(f"duplicate tensor {name!r}")
        arr = _as_numpy(array)
        dt = _dt_of(arr, name)
        if dt == DT_STRING:
            parts, crc = _string_bytes(arr)
            size = sum(len(p) for p in parts)
            for p in parts:
                self._f.write(p)
        else:
            raw = _little_endian_bytes(arr, dt)
            size = raw.size
            crc = crc32c.value(raw)
            self._f.write(raw.data)
        self._entries[key] = Entry(dt, arr.shape, 0, self._offset, size,
                                   crc32c.mask(crc))
        self._offset += size

    def finish(self) -> str:
        """Close the data file, write the index; returns the prefix."""
        self._f.close()
        items = [(b"", _header(1))] + [
            (k, self._entries[k].serialize()) for k in sorted(self._entries)]
        table = build_table(items)
        os.replace(self._tmp, self._data)
        tmp = index_filename(self.prefix) + f".tempstate{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(table)
        os.replace(tmp, index_filename(self.prefix))
        return self.prefix

    def abort(self):
        self._f.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.finish()
        else:
            self.abort()


def write_bundle(prefix, names: Iterable[str], arrays: Iterable) -> str:
    """Write ``arrays`` under ``names`` as a one-shard TensorBundle at
    ``prefix``, the data in the given order (as ``SaveV2`` writes them);
    ``arrays`` may be a generator, consumed one tensor at a time. Returns
    the prefix."""
    with TFBundleWriter(prefix) as w:
        for name, arr in zip(names, arrays, strict=True):
            w.add(name, arr)
    return w.prefix
