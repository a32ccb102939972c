"""Row gather / scatter over ``[C, W]`` tables — the row ops every table call
goes through.

Counterpart of ``tfplus_tpu/ops/rowops.py``. On a CUDA tensor each wrapper
launches its hand-written Hopper kernel (``csrc/rowops.cu``); on a CPU tensor
it runs the plain PyTorch version beside it, which is also the oracle the
kernel is held against. There is no switch and no fallback: a CUDA tensor
goes through the kernel or the wrapper raises.

Each wrapper counts its kernel launches in a plain integer attribute
(``gather_rows.launches``, ``scatter_rows.launches``) so that a run can show
that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_int64 = ctypes.c_longlong
_ptr = ctypes.c_void_p


def _rowops_lib() -> ctypes.CDLL:
    lib = _build.library("rowops")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_gather_rows.argtypes = [_ptr, _ptr, _ptr, _c_int64, _c_int64,
                                        _c_int64, _ptr]
        lib.tfp_gather_rows.restype = ctypes.c_int
        lib.tfp_scatter_rows.argtypes = [_ptr, _ptr, _ptr, _c_int64, _c_int64,
                                         _c_int64, ctypes.c_int, ctypes.c_int,
                                         _ptr]
        lib.tfp_scatter_rows.restype = ctypes.c_int
        lib._tfp_typed = True
    return lib


def _check(values: torch.Tensor, idx: torch.Tensor, rows=None) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be [C, W], got {tuple(values.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"values dtype {values.dtype} not supported "
                        "(float32, bfloat16)")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be int32[N], got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    tensors = [values, idx] if rows is None else [values, idx, rows]
    if rows is not None:
        if rows.dtype != values.dtype:
            raise TypeError(f"rows dtype {rows.dtype} != values dtype "
                            f"{values.dtype}")
        if rows.shape != (idx.shape[0], values.shape[1]):
            raise ValueError(f"rows must be [{idx.shape[0]}, "
                             f"{values.shape[1]}], got {tuple(rows.shape)}")
    if any(t.device != values.device for t in tensors):
        raise ValueError("values, idx and rows must share one device")
    if values.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {values.device}")
    if values.is_cuda and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA row kernels take contiguous tensors")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather_rows_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[clamp(idx, 0, C - 1)]`` in plain PyTorch."""
    return values[idx.long().clamp(0, values.shape[0] - 1)]


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` for row tables ([C, W] f32/bf16), idx int32[N].
    Negative idx rows return row 0 and idx >= C returns row C - 1 (as JAX
    clamps) — mask downstream."""
    _check(values, idx)
    if not values.is_cuda:
        return gather_rows_plain(values, idx)
    out = torch.empty((idx.shape[0], values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if idx.shape[0] == 0:
        return out
    err = _rowops_lib().tfp_gather_rows(
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        values.shape[0], values.shape[1] * values.element_size(),
        torch.cuda.current_stream(values.device).cuda_stream)
    _raise_on(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# scatter (set / accumulate)
# ---------------------------------------------------------------------------

def scatter_rows_plain(values: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor, add: bool = False) -> torch.Tensor:
    """In place: ``values[idx] = rows`` (or ``+=``) for idx in [0, C); other
    indices are dropped. Returns ``values``."""
    keep = (idx >= 0) & (idx < values.shape[0])
    k = idx[keep].long()
    if add:
        return values.index_add_(0, k, rows[keep])
    return values.index_copy_(0, k, rows[keep])


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 *, add: bool = False) -> torch.Tensor:
    """Write (or accumulate) ``rows`` into ``values`` at ``idx``, IN PLACE;
    indices < 0 or >= C are dropped. Returns ``values``.

    Indices must be unique (the engine dedups first); duplicates are
    undefined, as on the TPU path.
    """
    _check(values, idx, rows)
    if not values.is_cuda:
        return scatter_rows_plain(values, idx, rows, add)
    if idx.shape[0] == 0:
        return values
    err = _rowops_lib().tfp_scatter_rows(
        values.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
        values.shape[0], values.shape[1] * values.element_size(),
        _DTYPES[values.dtype], int(add),
        torch.cuda.current_stream(values.device).cuda_stream)
    _raise_on(err, "scatter_rows")
    scatter_rows.launches += 1
    return values


scatter_rows.launches = 0
