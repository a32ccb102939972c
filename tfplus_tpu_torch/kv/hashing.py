"""Key encoding and hashing for KV embedding tables.

Counterpart of ``tfplus_tpu/kv/hashing.py``, bit for bit. A key is a pair of
``int32`` words ``(lo, hi)``: a key batch is an ``int32[..., 2]`` tensor
(``[..., 0]`` = low word, ``[..., 1]`` = high word) covering the full
``uint64`` key space.

All 32-bit unsigned arithmetic runs in ``int64`` masked with
``& 0xFFFFFFFF``: torch on the CPU has no uint32 ``>>`` or ``%``.
Multiplications are split in 16-bit halves (:func:`_mul32`) so that no
intermediate leaves the signed 64-bit range.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import device as _dev

# Reserved sentinels (as uint64): EMPTY = 2**64 - 1, TOMBSTONE = 2**64 - 2.
# As int32 words these are (-1, -1) and (-2, -1).
EMPTY_LO = -1
EMPTY_HI = -1
TOMB_LO = -2
TOMB_HI = -1

_M32 = 0xFFFFFFFF
BUCKET_SIZE = 16


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for ``a`` in ``[0, 2**32)`` and a constant ``c``
    without overflowing int64: both partial products stay below 2**48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def encode_ids(ids, device="cuda") -> torch.Tensor:
    """Canonicalise user-facing ids into the ``int32[..., 2]`` key format.

    Accepts:
      * host ``numpy`` ``int64``/``uint64`` arrays (split into words),
      * ``int32`` tensors of shape ``[..., 2]`` (already encoded — passthrough),
      * other integer arrays or tensors of shape ``[...]`` (high word is the
        sign extension of the int32 value).

    Tensors stay on their device; host arrays go to ``device``.
    """
    if isinstance(ids, np.ndarray) and ids.dtype in (np.int64, np.uint64):
        u = ids.astype(np.uint64)
        lo = (u & np.uint64(_M32)).astype(np.uint32).astype(np.int32)
        hi = (u >> np.uint64(32)).astype(np.uint32).astype(np.int32)
        return torch.from_numpy(np.stack([lo, hi], axis=-1)).to(
            _dev.resolve(device))
    arr = _as_tensor(ids, device)
    if arr.ndim >= 1 and arr.shape[-1] == 2 and arr.dtype == torch.int32:
        return arr
    return _sign_extend(arr)


def encode_ids_raw(ids, device="cuda") -> torch.Tensor:
    """Like :func:`encode_ids` but NEVER interprets a trailing dim of 2 as
    already-encoded — use for raw id tensors of arbitrary shape."""
    if isinstance(ids, np.ndarray) and ids.dtype in (np.int64, np.uint64):
        return encode_ids(ids, device)
    return _sign_extend(_as_tensor(ids, device))


def encode_ids_np_to_device(ids: np.ndarray, device="cuda") -> torch.Tensor:
    """Host ``int64``/``uint64`` (or 32-bit) ids → ``int32[N, 2]`` on
    ``device``."""
    ids = np.asarray(ids)
    if ids.dtype not in (np.int64, np.uint64):
        ids = ids.astype(np.int64)
    return encode_ids(ids, device)


def _as_tensor(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids
    return torch.as_tensor(np.asarray(ids), device=_dev.resolve(device))


def _sign_extend(arr: torch.Tensor) -> torch.Tensor:
    if arr.dtype != torch.int32:
        # int64 → int32 keeps the low word (two's complement wrap)
        arr = ((arr.to(torch.int64) + (1 << 31)) & _M32) - (1 << 31)
        arr = arr.to(torch.int32)
    hi = torch.where(arr < 0, -1, 0).to(torch.int32)
    return torch.stack([arr, hi], dim=-1)


def decode_ids_np(keys) -> np.ndarray:
    """Host-side inverse of :func:`encode_ids` → ``uint64`` array."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    k = np.asarray(keys)
    lo = k[..., 0].astype(np.uint32).astype(np.uint64)
    hi = k[..., 1].astype(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def is_empty(keys: torch.Tensor) -> torch.Tensor:
    return (keys[..., 0] == EMPTY_LO) & (keys[..., 1] == EMPTY_HI)


def is_tombstone(keys: torch.Tensor) -> torch.Tensor:
    return (keys[..., 0] == TOMB_LO) & (keys[..., 1] == TOMB_HI)


def is_free(keys: torch.Tensor) -> torch.Tensor:
    """Slot can accept an insert (empty or tombstoned)."""
    return is_empty(keys) | is_tombstone(keys)


def is_reserved_id(keys: torch.Tensor) -> torch.Tensor:
    """User ids colliding with sentinels (2**64-1, 2**64-2) — rejected."""
    return is_free(keys)


def keys_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser over int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_words(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """Mix the two key words with a seed → int64 tensor of uint32 values."""
    lo = _u32(keys[..., 0])
    hi = _u32(keys[..., 1])
    h = _fmix32((lo + seed) & _M32)
    return _fmix32(h ^ _mul32(hi, 0x9E3779B9)
                   ^ ((seed * 0x01000193) & _M32))


def bucket_choices(keys: torch.Tensor,
                   capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-choice bucket hashing: each key may live in one of two contiguous
    16-slot buckets. Returns int64 bucket indices ``(b1, b2)`` into
    ``capacity // 16`` buckets, with ``b2 != b1``."""
    g = capacity // BUCKET_SIZE
    b1 = hash_words(keys, 0x2545F491) & (g - 1)
    b2 = hash_words(keys, 0x6A09E667) & (g - 1)
    b2 = torch.where(b2 == b1, (b2 + 1) & (g - 1), b2)
    return b1, b2


def shard_of(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard = ``key_u64 % num_shards`` (int64 tensor), computed with
    the same 32-bit arithmetic as the JAX package so that both route alike."""
    if num_shards == 1:
        return torch.zeros(keys.shape[:-1], dtype=torch.int64,
                           device=keys.device)
    lo = _u32(keys[..., 0])
    hi = _u32(keys[..., 1])
    if num_shards & (num_shards - 1) == 0:
        return lo & (num_shards - 1)
    # (hi * 2**32 + lo) mod ns, in 32-bit arithmetic
    two32_mod = (1 << 32) % num_shards
    t = (_mul32(hi % num_shards, two32_mod) + lo % num_shards) & _M32
    return t % num_shards


def init_row_indices(keys: torch.Tensor,
                     pool_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two deterministic pseudo-random rows of the init pool per key
    (int64 indices)."""
    r1 = hash_words(keys, 0x1B873593) % pool_size
    r2 = hash_words(keys, 0xCC9E2D51) % pool_size
    return r1, r2
