"""Criteo-Kaggle TSV reader and its binary cache.

Counterpart of ``tfplus_tpu/data/criteo.py``: the same arrays from the same
file, and the same cache layout, so a cache that either package writes is
read by the other. Format (example/dcn/README.md + train.py:40-44): label,
13 integer columns I1..I13, 26 categorical hex-string columns C1..C26,
tab-separated. Numeric values become ``log1p(max(v, 0))``; strings are
hashed with FNV-1a into 40 bits with the column index in the bits above, so
the 26 columns' ids never collide.

The readers parse through the native helper library (``io/native.py``)
and raise where it cannot be built: nothing falls back to Python without
being asked. :func:`python_batches` is the pure-Python reader (what the
JAX package runs without its library), the plain version the tests hold
the library's readers against.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np

from ..io import native as _native

NUM_NUMERIC = _native.NUM_NUMERIC
NUM_CATEGORICAL = _native.NUM_CATEGORICAL


def _fnv1a64(s: bytes) -> np.uint64:
    return np.uint64(_native._fnv1a64_py(s))


def available(path: Optional[str] = None) -> Optional[str]:
    for cand in ([path] if path else []) + [
            os.environ.get("CRITEO_PATH", ""),
            "/data/criteo/train.txt", "/root/data/criteo/train.txt"]:
        if cand and os.path.exists(cand):
            return cand
    return None


def _batch(numeric, cats, labels) -> Dict[str, np.ndarray]:
    return {"numeric": numeric, "categorical": cats, "label": labels}


def batches(path: str, batch_size: int,
            max_batches: Optional[int] = None, *,
            threads: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Stream full batches ``{"numeric" f32[B,13], "categorical"
    int64[B,26], "label" f32[B]}`` (the short tail is dropped).

    ``threads > 1`` uses the library's multithreaded prefetching loader
    (:class:`~tfplus_tpu_torch.io.native.CriteoLoader`; row order across
    chunks not preserved). ``threads in (0, 1)`` keeps the file's order
    through the library's one-shot parser."""
    if threads > 1:
        n_out = 0
        with _native.CriteoLoader(path, batch_size, threads=threads) as ld:
            for numeric, cats, labels in ld:
                if len(labels) < batch_size:
                    break  # fixed shapes; drop the short tail
                yield _batch(numeric, cats, labels)
                n_out += 1
                if max_batches and n_out >= max_batches:
                    return
        return
    yield from _batches_native(path, batch_size, max_batches)


def python_batches(path: str, batch_size: int,
                   max_batches: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """:func:`batches` in pure Python, one line at a time (the file's
    order, the short tail dropped)."""
    n_out = 0
    rows = []
    with open(path, "rb") as f:
        for line in f:
            row = _native.parse_criteo_line_py(line.rstrip(b"\n"))
            if row is None:
                continue
            rows.append(row)
            if len(rows) == batch_size:
                yield _rows_to_batch(rows)
                rows = []
                n_out += 1
                if max_batches and n_out >= max_batches:
                    return


def _rows_to_batch(rows) -> Dict[str, np.ndarray]:
    n = len(rows)
    return _batch(
        np.asarray([r[1] for r in rows], np.float64).reshape(
            n, NUM_NUMERIC).astype(np.float32),
        np.asarray([r[2] for r in rows], np.int64).reshape(
            n, NUM_CATEGORICAL),
        np.asarray([r[0] for r in rows], np.float64).astype(np.float32))


def _batches_native(path: str, batch_size: int,
                    max_batches: Optional[int],
                    chunk_bytes: Optional[int] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
    n_out = 0
    buf = b""
    chunk_bytes = chunk_bytes or max(batch_size * 512, 1 << 20)
    with open(path, "rb") as f:
        eof = False
        while True:
            if not eof and len(buf) < chunk_bytes:
                data = f.read(chunk_bytes)
                if data:
                    buf += data
                else:
                    eof = True
            numeric, cats, labels, consumed = _native.parse_criteo_batch(
                buf, batch_size)
            if len(labels) == batch_size:
                buf = buf[consumed:]
                yield _batch(numeric, cats, labels)
                n_out += 1
                if max_batches and n_out >= max_batches:
                    return
            elif eof:
                return  # incomplete trailing batch dropped
            else:
                # fewer than batch_size complete lines in the buffer (long
                # lines): read past chunk_bytes, or the loop would re-parse
                # the same buffer forever
                data = f.read(chunk_bytes)
                if data:
                    buf += data
                else:
                    eof = True


# ---------------------------------------------------------------------------
# Pre-tokenized binary cache: parse and hash once, then read memmapped
# slices. Layout (the JAX package's): a directory holding numeric.npy
# f32[N,13], categorical.npy int64[N,26] (hashed ids with their column
# tags), label.npy f32[N], and meta.json {"version", "rows", "source",
# "source_bytes"}.
# ---------------------------------------------------------------------------

_CACHE_META = "meta.json"
_CACHE_VERSION = 1


def _count_lines(path: str, chunk: int = 1 << 23) -> int:
    """Upper bound on the row count (malformed lines are skipped at parse
    time and the true count lands in meta.json)."""
    n = 0
    last = b"\n"
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            n += data.count(b"\n")
            last = data[-1:]
    if last != b"\n":
        n += 1  # final line without trailing newline
    return n


def _stream_parse_blocks(path: str, block_rows: int):
    """Yield (numeric, cats, labels) blocks INCLUDING the short tail block
    (a cache build must not drop rows)."""
    buf = b""
    chunk_bytes = max(block_rows * 512, 1 << 22)
    with open(path, "rb") as f:
        eof = False
        while True:
            if not eof and len(buf) < chunk_bytes:
                data = f.read(chunk_bytes)
                if data:
                    buf += data
                else:
                    eof = True
                    if buf and not buf.endswith(b"\n"):
                        buf += b"\n"   # let the parser take the last line
            numeric, cats, labels, consumed = _native.parse_criteo_batch(
                buf, block_rows)
            if len(labels):
                buf = buf[consumed:]
                yield numeric, cats, labels
            elif eof:
                return
            else:
                data = f.read(chunk_bytes)
                if data:
                    buf += data
                else:
                    eof = True
                    if buf and not buf.endswith(b"\n"):
                        buf += b"\n"


def build_binary_cache(tsv_path: str, cache_dir: str, *,
                       block_rows: int = 1 << 16) -> str:
    """One-time TSV → binary cache conversion (parse and hash once, in the
    file's order). Returns ``cache_dir``. An existing cache of the same
    version built from a source of the same size is reused."""
    meta_path = os.path.join(cache_dir, _CACHE_META)
    src_bytes = os.path.getsize(tsv_path)
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}
        if (meta.get("version") == _CACHE_VERSION
                and meta.get("source_bytes") == src_bytes):
            return cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    n_max = _count_lines(tsv_path)
    num_mm = np.lib.format.open_memmap(
        os.path.join(cache_dir, "numeric.npy"), mode="w+",
        dtype=np.float32, shape=(n_max, NUM_NUMERIC))
    cat_mm = np.lib.format.open_memmap(
        os.path.join(cache_dir, "categorical.npy"), mode="w+",
        dtype=np.int64, shape=(n_max, NUM_CATEGORICAL))
    lab_mm = np.lib.format.open_memmap(
        os.path.join(cache_dir, "label.npy"), mode="w+",
        dtype=np.float32, shape=(n_max,))
    i = 0
    for numeric, cats, labels in _stream_parse_blocks(tsv_path, block_rows):
        n = len(labels)
        num_mm[i:i + n] = numeric
        cat_mm[i:i + n] = cats
        lab_mm[i:i + n] = labels
        i += n
    for mm in (num_mm, cat_mm, lab_mm):
        mm.flush()
    with open(meta_path, "w") as f:
        json.dump({"version": _CACHE_VERSION, "rows": i,
                   "source": os.path.abspath(tsv_path),
                   "source_bytes": src_bytes}, f)
    return cache_dir


class BinaryCriteoCache:
    """Reader over a :func:`build_binary_cache` directory (either
    package's). ``batches`` yields memmap slice VIEWS: copy before
    mutating."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, _CACHE_META)) as f:
            meta = json.load(f)
        if meta.get("version") != _CACHE_VERSION:
            raise ValueError(f"unsupported cache version: {meta}")
        self.rows = int(meta["rows"])
        self.numeric = np.load(os.path.join(cache_dir, "numeric.npy"),
                               mmap_mode="r")
        self.categorical = np.load(
            os.path.join(cache_dir, "categorical.npy"), mmap_mode="r")
        self.label = np.load(os.path.join(cache_dir, "label.npy"),
                             mmap_mode="r")

    def batches(self, batch_size: int,
                max_batches: Optional[int] = None, *,
                loop: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Sequential fixed-size batches (short tail dropped).
        ``loop=True`` restarts at the beginning forever (epoch wraparound);
        pair it with ``max_batches``."""
        n_out = 0
        while True:
            for i in range(0, self.rows - batch_size + 1, batch_size):
                yield _batch(self.numeric[i:i + batch_size],
                             self.categorical[i:i + batch_size],
                             self.label[i:i + batch_size])
                n_out += 1
                if max_batches and n_out >= max_batches:
                    return
            if not loop:
                return
