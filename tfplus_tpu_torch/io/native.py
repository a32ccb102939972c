"""ctypes bindings for the native helper library (``native/tfplus_native.cc``).

Counterpart of ``tfplus_tpu/io/native.py``, with every ctypes signature as
it declares them. The port builds the library from the repository's source
at first use with ``g++ -O3 -march=native -std=c++17 -fPIC -pthread
-shared`` into ``tfplus_tpu_torch/_build/native/`` (listed in
``.gitignore``; ``native/``, where the JAX package builds its own copy, is
not touched). The file name carries a hash of the source and the flags; a
build writes a temporary name and renames it into place, so processes that
build at once never load half a file.

No silent fallback: the library's entry points (:func:`fingerprint64`,
:func:`fingerprint64_batch`, :func:`crc32`, :func:`parse_criteo_batch`,
:class:`CriteoLoader`) raise ``RuntimeError`` when it cannot be built or
loaded. The pure-Python twins (:func:`fingerprint64_py`, :func:`crc32_py`,
:func:`parse_criteo_batch_py`) compute the same bits; they are what the
JAX package runs without its library, and the plain versions the tests hold
the library against.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tfplus_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")

NUM_NUMERIC = 13
NUM_CATEGORICAL = 26
_FIELDS = 1 + NUM_NUMERIC + NUM_CATEGORICAL
_TAG_MASK = (1 << 40) - 1

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build_library(source: Path, build_dir: Path, flags, stem: str) -> Path:
    """Compile ``source`` with g++ and ``flags`` into
    ``build_dir/lib<stem>-<hash>.so`` unless that build is already there
    (the hash covers the source and the flags); raises ``RuntimeError``
    without g++ or on a failed build."""
    if not source.exists():
        raise RuntimeError(f"native source missing: {source}")
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    so = build_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source.name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)      # atomic: a reader never sees half a file
    return so


def _build() -> Path:
    """Compile the library unless this source's build is already there."""
    return build_library(SOURCE, BUILD_DIR, CXX_FLAGS, "tfplus_native")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The JAX package's ``_load`` signatures, one for one."""
    lib.tfp_fnv1a64.restype = ctypes.c_uint64
    lib.tfp_fnv1a64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tfp_farmhash64.restype = ctypes.c_uint64
    lib.tfp_farmhash64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tfp_farmhash64_batch.restype = None
    lib.tfp_farmhash64_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.tfp_crc32.restype = ctypes.c_uint32
    lib.tfp_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_uint32]
    lib.tfp_parse_criteo.restype = ctypes.c_int64
    lib.tfp_parse_criteo.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
    lib.tfp_fnv1a64_batch.restype = None
    lib.tfp_fnv1a64_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.tfp_loader_open.restype = ctypes.c_void_p
    lib.tfp_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int64]
    lib.tfp_loader_next.restype = ctypes.c_int64
    lib.tfp_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float)]
    lib.tfp_loader_close.restype = None
    lib.tfp_loader_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library (built at the first call); raises if it cannot
    be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(str(_build())))
        return _LIB


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


# ---------------------------------------------------------------------------
# FarmHash Fingerprint64 — pure-Python twin of the native implementation
# (the JAX package's, verbatim).
# ---------------------------------------------------------------------------

_M = 0xFFFFFFFFFFFFFFFF
_K0 = 0xC3A5C85C97CB3127
_K1 = 0xB492B66FBE98F273
_K2 = 0x9AE16A3B2F90404F


def _rot(v, s):
    return v if s == 0 else ((v >> s) | (v << (64 - s))) & _M


def _smix(v):
    return v ^ (v >> 47)


def _h16(u, v, mul):
    a = ((u ^ v) * mul) & _M
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M
    b ^= b >> 47
    return (b * mul) & _M


def _f64(s, i):
    return int.from_bytes(s[i:i + 8], "little")


def _f32(s, i):
    return int.from_bytes(s[i:i + 4], "little")


def _weak32(s, i, a, b):
    w, x, y, z = _f64(s, i), _f64(s, i + 8), _f64(s, i + 16), _f64(s, i + 24)
    a = (a + w) & _M
    b = _rot((b + a + z) & _M, 21)
    c = a
    a = (a + x + y) & _M
    b = (b + _rot(a, 44)) & _M
    return (a + z) & _M, (b + c) & _M


def _farmhash64_py(s: bytes) -> int:
    n = len(s)
    if n <= 16:
        if n >= 8:
            mul = (_K2 + n * 2) & _M
            a = (_f64(s, 0) + _K2) & _M
            b = _f64(s, n - 8)
            c = (_rot(b, 37) * mul + a) & _M
            d = ((_rot(a, 25) + b) * mul) & _M
            return _h16(c, d, mul)
        if n >= 4:
            mul = (_K2 + n * 2) & _M
            a = _f32(s, 0)
            return _h16((n + (a << 3)) & _M, _f32(s, n - 4), mul)
        if n > 0:
            a, b, c = s[0], s[n >> 1], s[n - 1]
            y = (a + (b << 8)) & _M
            z = (n + (c << 2)) & _M
            return (_smix((y * _K2 ^ z * _K0) & _M) * _K2) & _M
        return _K2
    if n <= 32:
        mul = (_K2 + n * 2) & _M
        a = (_f64(s, 0) * _K1) & _M
        b = _f64(s, 8)
        c = (_f64(s, n - 8) * mul) & _M
        d = (_f64(s, n - 16) * _K2) & _M
        return _h16((_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M,
                    (a + _rot((b + _K2) & _M, 18) + c) & _M, mul)
    if n <= 64:
        mul = (_K2 + n * 2) & _M
        a = (_f64(s, 0) * _K2) & _M
        b = _f64(s, 8)
        c = (_f64(s, n - 8) * mul) & _M
        d = (_f64(s, n - 16) * _K2) & _M
        y = (_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M
        z = _h16(y, (a + _rot((b + _K2) & _M, 18) + c) & _M, mul)
        e = (_f64(s, 16) * mul) & _M
        f = _f64(s, 24)
        g = ((y + _f64(s, n - 32)) * mul) & _M
        h = ((z + _f64(s, n - 24)) * mul) & _M
        return _h16((_rot((e + f) & _M, 43) + _rot(g, 30) + h) & _M,
                    (e + _rot((f + a) & _M, 18) + g) & _M, mul)
    seed = 81
    x = seed
    y = (seed * _K1 + 113) & _M
    z = (_smix((y * _K2 + 113) & _M) * _K2) & _M
    v1 = v2 = w1 = w2 = 0
    x = (x * _K2 + _f64(s, 0)) & _M
    end = ((n - 1) // 64) * 64
    last64 = end + ((n - 1) & 63) - 63
    i = 0
    while True:
        x = (_rot((x + y + v1 + _f64(s, i + 8)) & _M, 37) * _K1) & _M
        y = (_rot((y + v2 + _f64(s, i + 48)) & _M, 42) * _K1) & _M
        x ^= w2
        y = (y + v1 + _f64(s, i + 40)) & _M
        z = (_rot((z + w1) & _M, 33) * _K1) & _M
        v1, v2 = _weak32(s, i, (v2 * _K1) & _M, (x + w1) & _M)
        w1, w2 = _weak32(s, i + 32, (z + w2) & _M,
                         (y + _f64(s, i + 16)) & _M)
        z, x = x, z
        i += 64
        if i == end:
            break
    mul = (_K1 + ((z & 0xFF) << 1)) & _M
    i = last64
    w1 = (w1 + ((n - 1) & 63)) & _M
    v1 = (v1 + w1) & _M
    w1 = (w1 + v1) & _M
    x = (_rot((x + y + v1 + _f64(s, i + 8)) & _M, 37) * mul) & _M
    y = (_rot((y + v2 + _f64(s, i + 48)) & _M, 42) * mul) & _M
    x ^= (w2 * 9) & _M
    y = (y + v1 * 9 + _f64(s, i + 40)) & _M
    z = (_rot((z + w1) & _M, 33) * mul) & _M
    v1, v2 = _weak32(s, i, (v2 * mul) & _M, (x + w1) & _M)
    w1, w2 = _weak32(s, i + 32, (z + w2) & _M, (y + _f64(s, i + 16)) & _M)
    z, x = x, z
    return _h16((_h16(v1, w1, mul) + _smix(y) * _K0 + z) & _M,
                (_h16(v2, w2, mul) + x) & _M, mul)


def _fnv1a64_py(s: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in s:
        h = ((h ^ b) * 0x100000001B3) & _M
    return h


def fingerprint64_py(s: bytes, algo: str = "farmhash") -> int:
    """Pure-Python :func:`fingerprint64`."""
    return _fnv1a64_py(s) if algo == "fnv" else _farmhash64_py(s)


def fingerprint64(s: bytes, algo: str = "farmhash") -> int:
    """String feature key → uint64 id through the library.

    ``algo="farmhash"`` (default) is the reference's routing function
    (farmhash::Fingerprint64); ``algo="fnv"`` the FNV-1a ids of the
    Criteo loader's column hashing."""
    lib = _load()
    fn = lib.tfp_fnv1a64 if algo == "fnv" else lib.tfp_farmhash64
    return int(fn(s, len(s)))


def fingerprint64_batch(strings, algo: str = "farmhash") -> np.ndarray:
    """:func:`fingerprint64` of each string (bytes, or ``str(x)``
    encoded), uint64[N], in one library call."""
    lib = _load()
    bufs = [s if isinstance(s, bytes) else str(s).encode() for s in strings]
    blob = b"".join(bufs)
    offsets = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    out = np.zeros(len(bufs), np.uint64)
    fn = lib.tfp_farmhash64_batch if algo == "farmhash" \
        else lib.tfp_fnv1a64_batch
    fn(blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       len(bufs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def crc32_py(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def crc32(data: bytes, seed: int = 0) -> int:
    """CRC32 (zlib's polynomial) through the library."""
    return int(_load().tfp_crc32(data, len(data), seed))


def parse_criteo_batch(buf: bytes, max_rows: int):
    """Parse up to ``max_rows`` Criteo TSV lines from ``buf`` through the
    library.

    Returns ``(numeric f32[rows,13], cats int64[rows,26], labels f32[rows],
    consumed_bytes)``: complete lines only, so a caller can feed the rest
    again; a line with fewer than 40 fields is skipped."""
    lib = _load()
    numeric = np.zeros((max_rows, NUM_NUMERIC), np.float32)
    cats = np.zeros((max_rows, NUM_CATEGORICAL), np.int64)
    labels = np.zeros((max_rows,), np.float32)
    consumed = ctypes.c_int64(0)
    rows = int(lib.tfp_parse_criteo(
        buf, len(buf), max_rows,
        numeric.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(consumed)))
    return numeric[:rows], cats[:rows], labels[:rows], int(consumed.value)


def parse_criteo_line_py(line: bytes):
    """One Criteo TSV line (without its newline) → ``(label, numeric[13],
    cats[26])`` as Python numbers, or ``None`` for a line with fewer than
    40 fields (extra fields are ignored, as the library does). ``numeric``
    is ``log1p(max(v, 0))`` (0 when empty) and each categorical the FNV-1a
    hash of its text masked to 40 bits with the column index above it (0
    when empty)."""
    parts = line.split(b"\t")
    if len(parts) < _FIELDS:
        return None
    label = float(parts[0]) if parts[0] else 0.0
    numeric = [math.log1p(max(float(v), 0.0)) if v else 0.0
               for v in parts[1:1 + NUM_NUMERIC]]
    cats = [((_fnv1a64_py(v) & _TAG_MASK) | (j << 40)) if v else (j << 40)
            for j, v in enumerate(parts[1 + NUM_NUMERIC:_FIELDS])]
    return label, numeric, cats


def parse_criteo_batch_py(buf: bytes, max_rows: int):
    """Pure-Python :func:`parse_criteo_batch`, the same bits: float64
    values rounded once to float32, as the library's casts do."""
    labels, numeric, cats = [], [], []
    pos = 0
    while len(labels) < max_rows:
        eol = buf.find(b"\n", pos)
        if eol < 0:
            break
        row = parse_criteo_line_py(buf[pos:eol])
        pos = eol + 1
        if row is not None:
            labels.append(row[0])
            numeric.append(row[1])
            cats.append(row[2])
    n = len(labels)
    return (np.asarray(numeric, np.float64).reshape(n, NUM_NUMERIC)
            .astype(np.float32),
            np.asarray(cats, np.int64).reshape(n, NUM_CATEGORICAL),
            np.asarray(labels, np.float64).astype(np.float32), pos)


class CriteoLoader:
    """Multithreaded prefetching Criteo TSV loader (the library's reader
    thread, parser pool and bounded queue).

    Row order across chunks is NOT preserved for ``threads > 1``; use
    ``threads=1`` for the file's order. Iterate or call :meth:`next`; the
    final batch may be short; ``None`` marks the end of the stream.
    """

    def __init__(self, path: str, batch_size: int, *, threads: int = 4,
                 queue_cap: int = 8):
        self._lib = _load()
        self._batch = int(batch_size)
        self._h = self._lib.tfp_loader_open(str(path).encode(), int(threads),
                                            int(queue_cap))
        if not self._h:
            raise FileNotFoundError(path)

    def next(self):
        numeric = np.zeros((self._batch, NUM_NUMERIC), np.float32)
        cats = np.zeros((self._batch, NUM_CATEGORICAL), np.int64)
        labels = np.zeros((self._batch,), np.float32)
        got = self._lib.tfp_loader_next(
            self._h, self._batch,
            numeric.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got <= 0:
            return None
        return numeric[:got], cats[:got], labels[:got]

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tfp_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
