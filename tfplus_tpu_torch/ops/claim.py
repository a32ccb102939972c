"""Claim insert on the card: every claim round of one call in one launch.

A table places the keys it does not hold yet by claim rounds: in round *j*
each still-unplaced key tries its *j*-th candidate slot, and of the keys
that found a slot free the lowest query index takes it. On CPU tensors
:func:`tfplus_tpu_torch.kv.table._claim_rounds` runs the rounds as Python
loops of tensor ops; it is the plain version of this kernel and its oracle.
On CUDA tensors :func:`claim_insert` launches ``csrc/claim.cu``, which runs
every round on the device with barriers between its phases, so the rounds
read nothing back to the host, and leaves the same header and ``placed``
bit for bit. There is no fallback: a CPU tensor raises here, and the table
takes its Python rounds for CPU tensors itself.

With the table's init pool the kernel also writes each placed key's
initial payload row into a staging buffer, row for row with ``q``, which
the table scatters into its payload with the row kernel. It adds
``misses``, ``claim_rounds``, ``inserted`` and ``unplaced`` into the device
counter buffer of :func:`tfplus_tpu_torch.utils.profiling.device_counts`,
which :func:`~tfplus_tpu_torch.utils.profiling.counters` reads only when
asked. ``claim_insert.launches`` counts the launches. Every call is one
cooperative grid, as many blocks as its keys need up to what the card
holds at once: a training lookup's few thousand keys and a table's load
take the same code.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ..utils import profiling

MAX_PROBES = 32
_UNCLAIMED = 0x7FFFFFFF
_CTL_WORDS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_c_int64 = ctypes.c_longlong
_c_int = ctypes.c_int
_ptr = ctypes.c_void_p

# The claim words, one per slot, all "unclaimed" at rest: a call resets the
# words it touched, so one buffer of the largest capacity seen serves every
# table, per device and stream (a call on another stream could overlap).
_claim_words: dict = {}
_claim_words_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = _build.library("claim")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_claim_insert.argtypes = [
            _ptr, _c_int64, _ptr, _ptr, _c_int64, _c_int, _ptr, _ptr, _ptr,
            _ptr, _ptr, _c_int64, _ptr, _c_int64, _c_int64, _c_int, _ptr]
        lib.tfp_claim_insert.restype = _c_int
        lib._tfp_typed = True
    return lib


def _claim_buffer(device: torch.device, capacity: int,
                  stream: int) -> torch.Tensor:
    key = (device, stream)
    with _claim_words_lock:
        buf = _claim_words.get(key)
        if buf is None or buf.numel() < capacity:
            buf = _claim_words[key] = torch.full(
                (capacity,), _UNCLAIMED, dtype=torch.int32, device=device)
    return buf


def _check(header, q, need, max_probes, pool, rows) -> None:
    if not header.is_cuda:
        raise ValueError("claim_insert takes CUDA tensors; on the CPU the "
                         "table runs its Python claim rounds")
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
    if need.dtype != torch.bool or need.shape != (q.shape[0],):
        raise TypeError(f"need must be bool[{q.shape[0]}], got {need.dtype} "
                        f"{tuple(need.shape)}")
    if not 1 <= max_probes <= MAX_PROBES:
        raise ValueError(f"max_probes must be in [1, {MAX_PROBES}]")
    tensors = [header, q, need]
    if pool is not None:
        if pool.dtype not in _DTYPES or rows.dtype != pool.dtype:
            raise TypeError("pool and rows must share a float32, bfloat16 "
                            "or float16 dtype")
        if (pool.dim() != 2 or pool.shape[0] < 1 or rows.dim() != 2
                or rows.shape[0] != q.shape[0]
                or rows.shape[1] < pool.shape[1]):
            raise ValueError(f"pool must be [P, D] and rows "
                             f"[{q.shape[0]}, >= D]")
        if not (pool.is_contiguous() and rows.is_contiguous()):
            raise ValueError("pool and rows must be contiguous")
        tensors += [pool, rows]
    if any(t.device != header.device for t in tensors):
        raise ValueError("all tensors must share the header's device")


def claim_insert(header: torch.Tensor, q: torch.Tensor, need: torch.Tensor,
                 max_probes: int, *, pool=None, rows=None) -> torch.Tensor:
    """Place the keys of ``q`` (int32[N, 2], unique or with twins) whose
    ``need`` is set, IN PLACE on ``header``; returns ``placed`` int32[N]
    (the slot, -1 where no candidate slot was free or ``need`` is unset).
    With ``pool`` (the init pool, [P, D]) and ``rows`` ([N, W], W >= D),
    also writes row i of ``rows`` for each placed key i: D embedding
    columns from the pool, zeros in the rest (rows of unplaced keys are
    left as they were). One launch, no host read."""
    _check(header, q, need, max_probes, pool, rows)
    n = q.shape[0]
    dev = header.device
    placed = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return placed
    q, need = q.contiguous(), need.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    claim = _claim_buffer(dev, header.shape[0] * 16, stream)
    scratch = torch.empty((_CTL_WORDS + 4 * n,), dtype=torch.int32,
                          device=dev)
    err = _lib().tfp_claim_insert(
        header.data_ptr(), header.shape[0], q.data_ptr(), need.data_ptr(), n,
        max_probes, placed.data_ptr(), claim.data_ptr(), scratch.data_ptr(),
        profiling.device_counts(dev).data_ptr(),
        pool.data_ptr() if pool is not None else None,
        pool.shape[0] if pool is not None else 0,
        rows.data_ptr() if pool is not None else None,
        rows.shape[1] if pool is not None else 0,
        pool.shape[1] if pool is not None else 0,
        _DTYPES[pool.dtype] if pool is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"claim_insert kernel launch failed: "
                           f"cudaError {err}")
    claim_insert.launches += 1
    return placed


claim_insert.launches = 0
