"""Monotone compactor: pack the live rows of an append arena into a dense
prefix, in order.

Counterpart of ``tfplus_tpu/ops/compactor.py``, an entry point that no
engine path calls (in the JAX package it is a parked primitive, and the
port does not wire it into the table either). On a CUDA tensor
:func:`compact` launches the hand-written Hopper kernel
(``csrc/compactor.cu``); on a CPU tensor it runs :func:`compact_plain`,
which is also the oracle the kernel is held against. There is no fallback:
a CUDA tensor goes through the kernel or the wrapper raises.

Two contracts, as in the JAX package:

* the kernel's (:func:`compact`, :func:`compact_plain`): ``new_loc`` of a
  dead row is 0, and only ``packed[:n_live]`` is defined;
* the oracle's (:func:`compact_reference`): ``new_loc`` of a dead row is its
  exclusive prefix count, and ``packed`` past the live rows is zeros.

``compact.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARENA_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_c_int64 = ctypes.c_longlong
_ptr = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.library("compactor")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_compact.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _c_int64,
                                    _c_int64, _c_int64, _c_int64, _ptr]
        lib.tfp_compact.restype = ctypes.c_int
        lib._tfp_typed = True
    return lib


def _check(arena: torch.Tensor, live: torch.Tensor, block_rows: int,
           out_rows) -> int:
    """The JAX entry point's three ValueErrors, then type, shape and device
    checks. Returns ``out_rows`` resolved (default: the arena's rows)."""
    if arena.dim() != 2:
        raise ValueError(f"arena must be [M, W], got {tuple(arena.shape)}")
    m, w = arena.shape
    r = block_rows
    if m % r:
        raise ValueError(f"arena rows {m} must divide block_rows {r}")
    if w % 128:
        raise ValueError(f"row width {w} must be a multiple of 128 lanes")
    out_rows = out_rows or m
    if out_rows % r:
        raise ValueError("out_rows must divide block_rows")
    if arena.dtype not in _ARENA_DTYPES:
        raise TypeError(f"arena dtype {arena.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if live.dtype != torch.bool or live.shape != (m,):
        raise TypeError(f"live must be bool[{m}], got {live.dtype} "
                        f"{tuple(live.shape)}")
    if live.device != arena.device:
        raise ValueError("arena and live must share one device")
    if arena.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {arena.device}")
    if arena.is_cuda and not (arena.is_contiguous() and live.is_contiguous()):
        raise ValueError("the CUDA compactor takes contiguous tensors")
    return out_rows


def compact_plain(arena: torch.Tensor, live: torch.Tensor, *,
                  out_rows=None):
    """The kernel's contract in plain PyTorch: ``(packed f32[out_rows, W],
    new_loc int32[M])`` with ``packed[:n_live]`` the live rows in arena
    order (rows past ``out_rows`` dropped; the rest of ``packed`` is left
    unwritten) and ``new_loc`` the packed position of each live row, 0 for
    dead rows."""
    m, w = arena.shape
    out_rows = out_rows or m
    live_i = live.to(torch.int32)
    excl = torch.cumsum(live_i, 0, dtype=torch.int32) - live_i
    new_loc = torch.where(live, excl, 0).to(torch.int32)
    rows = arena[live][:out_rows].to(torch.float32)
    packed = torch.empty((out_rows, w), dtype=torch.float32,
                         device=arena.device)
    packed[:rows.shape[0]] = rows
    return packed, new_loc


def compact_reference(arena: torch.Tensor, live: torch.Tensor,
                      out_rows=None):
    """The JAX oracle's contract: ``packed`` [out_rows, W] in the arena's
    dtype, zeros past the live rows; ``new_loc`` the exclusive prefix count
    of live rows for EVERY row (dead rows too)."""
    m, w = arena.shape
    out_rows = out_rows or m
    live_i = live.to(torch.int32)
    new_loc = torch.cumsum(live_i, 0, dtype=torch.int32) - live_i
    keep = live & (new_loc < out_rows)
    packed = arena.new_zeros((out_rows, w))
    packed[new_loc[keep].long()] = arena[keep]
    return packed, new_loc


def compact(arena: torch.Tensor, live: torch.Tensor, *,
            block_rows: int = 128, out_rows=None, interpret: bool = False):
    """Pack ``arena``'s live rows into a dense prefix, preserving order.

    Returns ``(packed f32[out_rows, W], new_loc int32[M])``: ``packed[:n]``
    (n live rows) are the live rows in arena order, and ``new_loc[j]`` is
    live row j's packed position, 0 for a dead row. Only ``packed[:n]`` is
    defined: the rows past it are allocation, never written. ``out_rows``
    defaults to M; live rows past it are dropped. The arena is cast to
    float32 by this wrapper (the JAX entry point casts it too), so the
    kernel only copies f32 rows. ``block_rows`` (R) must divide M and
    ``out_rows``; W must be a multiple of 128. ``interpret`` is accepted
    for the JAX signature and unused."""
    del interpret
    out_rows = _check(arena, live, block_rows, out_rows)
    if not arena.is_cuda:
        return compact_plain(arena, live, out_rows=out_rows)
    m, w = arena.shape
    a = arena.to(torch.float32)
    nblk = m // block_rows
    # per-block live counts and their exclusive prefix, outside the kernel
    # (as in the JAX entry point): out_start[b] is block b's first row
    counts = live.view(nblk, block_rows).sum(1, dtype=torch.int32)
    out_start = torch.cat([counts.new_zeros(1),
                           torch.cumsum(counts, 0, dtype=torch.int32)])
    packed = torch.empty((out_rows, w), dtype=torch.float32,
                         device=arena.device)
    new_loc = torch.empty(m, dtype=torch.int32, device=arena.device)
    if m == 0:
        return packed, new_loc
    err = _lib().tfp_compact(
        a.data_ptr(), live.data_ptr(), out_start.data_ptr(),
        packed.data_ptr(), new_loc.data_ptr(), m, w, block_rows, out_rows,
        torch.cuda.current_stream(arena.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact kernel launch failed: cudaError {err}")
    compact.launches += 1
    return packed, new_loc


compact.launches = 0
