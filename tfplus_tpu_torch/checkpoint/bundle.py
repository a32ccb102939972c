"""Sharded streaming tensor bundle — the on-disk checkpoint container.

A copy of ``tfplus_tpu/checkpoint/bundle.py``, so that a bundle either
package writes reads in the other: the reference's TensorBundle
capabilities (streaming append of huge tensors segment by segment, a CRC32
per tensor, sharded data files, partial reads, little-endian on disk) with
a JSON index.

Layout:
    <prefix>.index.json                 {tensor_name: entry}
    <prefix>.data-00000-of-0000N        raw little-endian tensor bytes

A tensor may be written in one shot (:meth:`BundleWriter.add`) or streamed
segment by segment (:meth:`add_header` + :meth:`append_segment` +
:meth:`end_segment`).
"""
from __future__ import annotations

import json
import os
import sys
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io.filesystem import get_filesystem

_INDEX_SUFFIX = ".index.json"


def _to_little_endian(array: np.ndarray) -> np.ndarray:
    """Canonicalise to the bundle's little-endian on-disk contract
    (reference: byte_swap.{h,cc} — bundles are byte-swapped on endian
    mismatch so checkpoints move between architectures)."""
    dt = array.dtype
    if dt.byteorder == ">" or (dt.byteorder == "=" and sys.byteorder == "big"):
        return array.astype(dt.newbyteorder("<"))
    return array


def _to_native(array: np.ndarray) -> np.ndarray:
    """Byte-swap a non-native-order array to native (read path: lets a
    big-endian host read LE bundles and a little-endian host read legacy
    BE-written tensors)."""
    if array.dtype.isnative:
        return array
    return array.astype(array.dtype.newbyteorder("="))


def data_filename(prefix: str, shard: int, num_shards: int) -> str:
    """Shard path scheme (kernels/naming.cc:35)."""
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def index_filename(prefix: str) -> str:
    return prefix + _INDEX_SUFFIX


class BundleWriter:
    """Append-only writer; assign tensors to shards round-robin or explicitly."""

    def __init__(self, prefix: str, num_shards: int = 1):
        self._fs, self._prefix = get_filesystem(prefix)
        self._num_shards = num_shards
        d = os.path.dirname(self._prefix)
        if d:
            self._fs.makedirs(d)
        self._files = [
            self._fs.open(data_filename(self._prefix, i, num_shards), "wb")
            for i in range(num_shards)]
        self._index: Dict[str, dict] = {}
        self._next_shard = 0
        self._open_stream: Optional[Tuple[str, int]] = None
        self._closed = False

    # -- one-shot ----------------------------------------------------------
    def add(self, name: str, array: np.ndarray, shard: Optional[int] = None):
        array = _to_little_endian(np.ascontiguousarray(array))
        self.add_header(name, array.dtype, array.shape, shard)
        self.append_segment(array)
        self.end_segment()

    def add_alias(self, name: str, target: str):
        """Record ``name`` as an alias of an already-written tensor — zero
        data bytes. Used for logically-duplicate contract tensors (the
        reference writes ``-freq_keys`` with the same content as ``-keys``;
        aliasing keeps the logical tensor without doubling disk)."""
        if name in self._index:
            raise ValueError(f"duplicate tensor {name!r}")
        if target not in self._index:
            raise ValueError(f"alias target {target!r} not written yet")
        if "alias" in self._index[target]:
            target = self._index[target]["alias"]
        self._index[name] = {"alias": target}

    # -- streaming (tensor_bundle.cc:652-746 semantics) --------------------
    def add_header(self, name: str, dtype, shape, shard: Optional[int] = None):
        if self._open_stream is not None:
            raise RuntimeError("previous stream not ended")
        if name in self._index:
            raise ValueError(f"duplicate tensor {name!r}")
        if shard is None:
            shard = self._next_shard
            self._next_shard = (self._next_shard + 1) % self._num_shards
        f = self._files[shard]
        # index always declares the LE on-disk order (byte_swap parity)
        dt = np.dtype(dtype)
        if dt.byteorder == ">" or (dt.byteorder == "=" and sys.byteorder == "big"):
            dt = dt.newbyteorder("<")
        self._index[name] = {
            "shard": shard,
            "offset": f.tell(),
            "dtype": dt.str,
            "shape": [int(s) for s in shape],
            "nbytes": 0,
            "crc32": 0,
        }
        self._open_stream = (name, shard)

    def append_segment(self, array_or_bytes):
        if self._open_stream is None:
            raise RuntimeError("add_header first")
        name, shard = self._open_stream
        buf = (_to_little_endian(array_or_bytes).tobytes()
               if isinstance(array_or_bytes, np.ndarray) else bytes(array_or_bytes))
        entry = self._index[name]
        entry["crc32"] = zlib.crc32(buf, entry["crc32"]) & 0xFFFFFFFF
        entry["nbytes"] += len(buf)
        self._files[shard].write(buf)

    def end_segment(self):
        if self._open_stream is None:
            raise RuntimeError("no open stream")
        name, _ = self._open_stream
        entry = self._index[name]
        want = int(np.prod(entry["shape"], dtype=np.int64)) * np.dtype(entry["dtype"]).itemsize
        if entry["nbytes"] != want:
            raise ValueError(
                f"{name}: wrote {entry['nbytes']} bytes, shape implies {want}")
        self._open_stream = None

    def close(self):
        if self._closed:
            return
        if self._open_stream is not None:
            raise RuntimeError(f"unterminated stream {self._open_stream[0]!r}")
        for f in self._files:
            f.close()
        tmp = index_filename(self._prefix) + ".tmp"
        with self._fs.open(tmp, "wb") as f:
            f.write(json.dumps({"version": 1, "num_shards": self._num_shards,
                                "tensors": self._index}).encode())
        self._fs.rename(tmp, index_filename(self._prefix))  # atomic publish
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            for f in self._files:
                f.close()


class BundleReader:
    def __init__(self, prefix: str):
        self._fs, self._prefix = get_filesystem(prefix)
        with self._fs.open(index_filename(self._prefix), "rb") as f:
            meta = json.loads(f.read().decode())
        self._num_shards = meta["num_shards"]
        self._index = meta["tensors"]

    def _entry(self, name: str) -> dict:
        e = self._index[name]
        return self._index[e["alias"]] if "alias" in e else e

    def keys(self) -> List[str]:
        return list(self._index.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def shape(self, name: str):
        return tuple(self._entry(name)["shape"])

    def num_elements(self, name: str) -> int:
        """Leading-axis length of a tensor, 0 if absent (cheap index read)."""
        if name not in self._index:
            return 0
        e = self._entry(name)
        if not e["shape"]:
            return 0
        return int(e["shape"][0])

    def dtype(self, name: str):
        return np.dtype(self._entry(name)["dtype"])

    def lookup(self, name: str, verify: bool = True) -> np.ndarray:
        e = self._entry(name)
        path = data_filename(self._prefix, e["shard"], self._num_shards)
        with self._fs.open(path, "rb") as f:
            f.seek(e["offset"])
            buf = f.read(e["nbytes"])
        if len(buf) != e["nbytes"]:
            raise IOError(f"{name}: truncated read from {path}")
        if verify and (zlib.crc32(buf) & 0xFFFFFFFF) != e["crc32"]:
            raise IOError(f"{name}: CRC mismatch in {path}")
        return _to_native(
            np.frombuffer(buf, dtype=np.dtype(e["dtype"])).reshape(e["shape"]))

    def lookup_slice(self, name: str, start_row: int, num_rows: int) -> np.ndarray:
        """Partial read of leading-axis rows (BundleReader::LookupWithIndices,
        tensor_bundle.cc:597-607) — lets restore stream huge tables."""
        e = self._entry(name)
        shape = e["shape"]
        if not shape:
            raise ValueError("lookup_slice requires rank >= 1")
        row_bytes = (int(np.prod(shape[1:], dtype=np.int64))
                     * np.dtype(e["dtype"]).itemsize)
        path = data_filename(self._prefix, e["shard"], self._num_shards)
        with self._fs.open(path, "rb") as f:
            f.seek(e["offset"] + start_row * row_bytes)
            buf = f.read(num_rows * row_bytes)
        return _to_native(np.frombuffer(buf, dtype=np.dtype(e["dtype"]))
                          .reshape((num_rows,) + tuple(shape[1:])))

    def stream(self, name: str, chunk_rows: int,
               verify: bool = True) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start_row, rows)`` chunks covering the whole tensor in
        order, with bounded memory. Because chunks cover the byte range
        sequentially, the per-tensor CRC is accumulated across chunks and
        verified at the end — integrity checking that plain
        :meth:`lookup_slice` cannot give."""
        e = self._entry(name)
        shape = e["shape"]
        if not shape:
            raise ValueError("stream requires rank >= 1")
        n = int(shape[0])
        row_bytes = (int(np.prod(shape[1:], dtype=np.int64))
                     * np.dtype(e["dtype"]).itemsize)
        path = data_filename(self._prefix, e["shard"], self._num_shards)
        crc = 0
        with self._fs.open(path, "rb") as f:
            f.seek(e["offset"])
            for start in range(0, n, chunk_rows):
                rows = min(chunk_rows, n - start)
                buf = f.read(rows * row_bytes)
                if len(buf) != rows * row_bytes:
                    raise IOError(f"{name}: truncated read from {path}")
                crc = zlib.crc32(buf, crc) & 0xFFFFFFFF
                yield start, _to_native(
                    np.frombuffer(buf, dtype=np.dtype(e["dtype"]))
                    .reshape((rows,) + tuple(shape[1:])))
        if verify and n and crc != e["crc32"]:
            raise IOError(f"{name}: CRC mismatch in {path}")

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for k in self.keys():
            yield k, self.lookup(k)
