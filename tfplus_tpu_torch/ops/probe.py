"""The table's probe on the card: hash, both bucket reads and the lane scans
of every query key in one launch.

A table finds a key by hashing it to two 16-slot buckets and scanning both
buckets' header rows for its words and for a free lane. On CPU tensors
:func:`tfplus_tpu_torch.kv.table._find_plain` runs that as eager tensor ops;
it is the plain version of this kernel and its oracle. On CUDA tensors
:func:`probe` launches ``csrc/probe.cu``, which gives the same outputs bit
for bit, with no host read. There is no fallback: a CPU tensor raises here,
and the table takes its plain version for CPU tensors itself.

The kernel adds ``probed`` (valid keys) and ``found`` into the device
counter buffer of :func:`tfplus_tpu_torch.utils.profiling.device_counts`,
which :func:`~tfplus_tpu_torch.utils.profiling.counters` reads only when
asked. ``probe.launches`` counts the launches; a call with no key launches
nothing. The grid follows the number of keys, and the pad plane is read
only with ``want_pad``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ..utils import profiling

_c_int64 = ctypes.c_longlong
_c_int = ctypes.c_int
_ptr = ctypes.c_void_p
#: the byte offset of ``probed`` (then ``found``) in the device counter buffer
_COUNTS_AT = 8 * profiling.DEVICE_COUNTERS.index("probed")


def _lib() -> ctypes.CDLL:
    lib = _build.library("probe")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_probe.argtypes = [
            _ptr, _c_int64, _ptr, _ptr, _c_int64, _c_int, _ptr, _ptr, _ptr,
            _ptr, _ptr, _ptr, _ptr]
        lib.tfp_probe.restype = _c_int
        lib._tfp_typed = True
    return lib


def _check(header, q, valid) -> None:
    if not header.is_cuda:
        raise ValueError("probe takes CUDA tensors; on the CPU the table "
                         "runs its plain find")
    if (header.dtype != torch.int32 or header.dim() != 2
            or header.shape[1] != 64 or not header.is_contiguous()):
        raise TypeError("header must be a contiguous int32[G, 64]")
    g = header.shape[0]
    if g & (g - 1) or not 2 <= g <= 1 << 26:
        raise ValueError(f"header must hold 2..2**26 buckets, a power of "
                         f"two, got {g}")
    if q.dtype != torch.int32 or q.dim() != 2 or q.shape[1] != 2:
        raise TypeError(f"q must be int32[N, 2], got {q.dtype} "
                        f"{tuple(q.shape)}")
    if q.device != header.device:
        raise ValueError("q must be on the header's device")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != (q.shape[0],):
            raise TypeError(f"valid must be bool[{q.shape[0]}], got "
                            f"{valid.dtype} {tuple(valid.shape)}")
        if valid.device != header.device:
            raise ValueError("valid must be on the header's device")


def probe(header: torch.Tensor, q: torch.Tensor,
          valid: Optional[torch.Tensor] = None, want_pad: bool = False):
    """Probe both candidate buckets of each key of ``q`` (int32[N, 2]) in
    ``header``; ``valid`` (bool[N]) or None for all. Returns ``(slot,
    found, insert_slot, meta, pad)`` as :class:`kv.table.FindResult` holds
    them: int32, bool, int32, int64 holding the uint32 meta word, and the
    int32 pad-lane word only with ``want_pad`` (else None). One launch, no
    host read."""
    _check(header, q, valid)
    n = q.shape[0]
    dev = header.device
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    insert_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    meta = torch.empty((n,), dtype=torch.int64, device=dev)
    pad = (torch.empty((n,), dtype=torch.int32, device=dev) if want_pad
           else None)
    if n == 0:
        return slot, found, insert_slot, meta, pad
    q = q.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    err = _lib().tfp_probe(
        header.data_ptr(), header.shape[0], q.data_ptr(),
        valid.data_ptr() if valid is not None else None, n, int(want_pad),
        slot.data_ptr(), found.data_ptr(), insert_slot.data_ptr(),
        meta.data_ptr(), pad.data_ptr() if want_pad else None,
        profiling.device_counts(dev).data_ptr() + _COUNTS_AT,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {err}")
    probe.launches += 1
    return slot, found, insert_slot, meta, pad


probe.launches = 0
