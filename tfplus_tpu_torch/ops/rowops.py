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

The kernels pick a launch plan from the row's bytes, the count of rows and
the pointers' alignment (:func:`plan` returns it): the widest word (16, 8, 4
or 2 bytes) that divides the row and the alignment; a group of
``min(32, next_pow2(words))`` lanes per row, so that a warp moves several
narrow rows at once, and for rows wider than 32 words up to 8 words per
lane; one row in flight per lane (two where a lane holds one word of a
row and the rows outnumber twice what one wave of the card holds); a warp
for every tile of rows. The plan is a fixed rule of the shapes, not a
choice made at run time: a CUDA tensor goes through these kernels or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KINDS = {"gather": 0, "set": 1, "add": 2}
PLAN_KEYS = ("word_bytes", "lanes_per_row", "words_per_lane",
             "rows_in_flight", "grid", "block")
_c_int64 = ctypes.c_longlong
_c_int = ctypes.c_int
_ptr = ctypes.c_void_p
_Plan = ctypes.c_int * len(PLAN_KEYS)
_GATHER_ARGS = [_ptr, _ptr, _ptr, _c_int64, _c_int64, _c_int64]
_SCATTER_ARGS = _GATHER_ARGS + [_c_int, _c_int]
_SIGNATURES = {
    "tfp_gather_rows": _GATHER_ARGS + [_ptr],
    "tfp_scatter_rows": _SCATTER_ARGS + [_ptr],
    "tfp_rowops_plan": [_c_int64, _c_int64, _c_int64, _c_int, _c_int, _ptr]}


def _rowops_lib() -> ctypes.CDLL:
    """The library built from ``csrc/rowops.cu``, its functions typed."""
    lib = _build.library("rowops")
    if not getattr(lib, "_tfp_typed", False):
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _c_int
        lib._tfp_typed = True
    return lib


def _check(values: torch.Tensor, idx: torch.Tensor, rows=None) -> None:
    if values.dim() != 2:
        raise ValueError(f"values must be [C, W], got {tuple(values.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"values dtype {values.dtype} not supported "
                        "(float32, bfloat16, float16)")
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _align(*tensors: torch.Tensor) -> int:
    """The largest power of two (up to 256) dividing every base address."""
    p = 0
    for t in tensors:
        p |= t.data_ptr()
    return 256 if p == 0 else min(256, p & -p)


def plan(row_bytes: int, n: int, *, align: int = 256,
         dtype: torch.dtype = torch.float32, kind: str = "gather") -> dict:
    """The launch plan the kernels take for ``n`` rows of ``row_bytes``
    bytes whose base pointers are multiples of ``align`` (``kind``:
    "gather", "set" or "add"): a dict of ``PLAN_KEYS``. Needs the card (the
    rule reads its SM count)."""
    out = _Plan()
    _raise_on(_rowops_lib().tfp_rowops_plan(row_bytes, n, align,
                                            _DTYPES[dtype], KINDS[kind], out),
              "rowops plan")
    return dict(zip(PLAN_KEYS, out))


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather_rows_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[clamp(idx, 0, C - 1)]`` in plain PyTorch."""
    return values[idx.long().clamp(0, values.shape[0] - 1)]


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` for row tables ([C, W] f32/bf16/f16), idx int32[N].
    Negative idx rows return row 0 and idx >= C returns row C - 1 (as JAX
    clamps) — mask downstream."""
    _check(values, idx)
    if not values.is_cuda:
        return gather_rows_plain(values, idx)
    out = torch.empty((idx.shape[0], values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if idx.shape[0] == 0:
        return out
    _raise_on(_rowops_lib().tfp_gather_rows(*_gather_args(values, idx, out),
                                            _stream(values)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def _gather_args(values, idx, out):
    return (values.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            values.shape[0], values.shape[1] * values.element_size())


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
    _raise_on(_rowops_lib().tfp_scatter_rows(
        *_scatter_args(values, idx, rows, add), _stream(values)),
        "scatter_rows")
    scatter_rows.launches += 1
    return values


scatter_rows.launches = 0


def _scatter_args(values, idx, rows, add):
    return (values.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
            values.shape[0], values.shape[1] * values.element_size(),
            _DTYPES[values.dtype], int(add))

