"""CRC32C for TensorFlow TensorBundle checkpoints, with the masking TF
stores it under.

The checksum is computed by ``checkpoint/csrc/crc32c.cc``: built with
``g++ -O3 -std=c++17 -fPIC -shared`` (and ``-msse4.2`` on x86-64, where it
runs the hardware CRC32C instruction) into
``tfplus_tpu_torch/_build/crc32c/`` at first use by
:func:`tfplus_tpu_torch.io.native.build_library` (the file name carries a
hash of the source and the flags) and bound by ctypes.

No silent fallback: :func:`extend` raises ``RuntimeError`` when the library
cannot be built or loaded. :func:`extend_py` is the bytewise plain version
the tests hold the library against; nothing on the checkpoint path calls
it.
"""
from __future__ import annotations

import ctypes
import platform
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.native import build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "crc32c.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "crc32c"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())

POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The loaded library (built at the first call); raises if it cannot
    be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library(SOURCE, BUILD_DIR,
                                                CXX_FLAGS, "crc32c")))
            for fn in (lib.tfp_crc32c_extend, lib.tfp_crc32c_extend_sw):
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                               ctypes.c_int64]
            lib.tfp_crc32c_hardware.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _pointer(data):
    """``(address, nbytes, keepalive)`` of a bytes-like object or a
    C-contiguous numpy array."""
    if isinstance(data, np.ndarray):
        if not data.flags.c_contiguous:
            data = np.ascontiguousarray(data)
        return data.ctypes.data, data.nbytes, data
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value, \
            len(data), data
    arr = np.frombuffer(data, np.uint8)
    return arr.ctypes.data, arr.nbytes, arr


def _run(fn, crc: int, data) -> int:
    ptr, n, _keep = _pointer(data)
    if n == 0:
        return crc & 0xFFFFFFFF
    return int(fn(crc & 0xFFFFFFFF, ptr, n))


def extend(crc: int, data) -> int:
    """CRC32C of ``data`` continuing from ``crc`` (0 to start), by the
    library. ``data``: bytes, a buffer or a contiguous numpy array."""
    return _run(_load().tfp_crc32c_extend, crc, data)


def value(data) -> int:
    return extend(0, data)


def hardware() -> bool:
    """Whether the library runs the CPU's CRC32C instruction."""
    return bool(_load().tfp_crc32c_hardware())


def extend_table_loop(crc: int, data) -> int:
    """The library's table loop, the only route on CPUs without the CRC32C
    instruction; on others for rates and tests."""
    return _run(_load().tfp_crc32c_extend_sw, crc, data)


def mask(crc: int) -> int:
    """TF's stored form of a CRC (``crc32c::Mask``): rotate right by 15,
    add a constant."""
    crc &= 0xFFFFFFFF
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) \
        & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the plain version: bytewise, one table of 256 words
# ---------------------------------------------------------------------------

def _table():
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        out.append(c)
    return out


_TABLE = _table()


def extend_py(crc: int, data) -> int:
    """CRC32C of ``data`` continuing from ``crc``, one byte at a time."""
    c = (crc & 0xFFFFFFFF) ^ 0xFFFFFFFF
    for b in bytes(data):
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
