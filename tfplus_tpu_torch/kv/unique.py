"""Fixed-shape unique-with-counts for id batches.

Counterpart of ``tfplus_tpu/kv/unique.py``: returns ``[N]`` outputs padded
with the EMPTY sentinel plus the number of valid uniques, in the JAX
package's order — valid keys first, sorted by (signed hi, signed lo).
``_claim_insert`` gives a contested slot to the lowest unique index, so this
order decides placement and must match bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import hashing


class UniqueResult(NamedTuple):
    """All tensors have static shape [N] (N = input size)."""

    unique_keys: torch.Tensor   # int32[N, 2]; rows >= num_unique are EMPTY
    inverse: torch.Tensor       # int32[N]: position of each input id in unique_keys
    counts: torch.Tensor        # int32[N]: multiplicity of each unique id (0 on pads)
    num_unique: torch.Tensor    # int32 scalar


def unique_with_counts(keys: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> UniqueResult:
    """Dedup encoded keys ``int32[N, 2]``.

    ``valid`` masks out padding slots of the input (invalid entries get
    ``inverse`` pointing at a pad row whose count is 0).
    """
    n = keys.shape[0]
    dev = keys.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    lo = torch.where(valid, keys[:, 0], hashing.EMPTY_LO)
    hi = torch.where(valid, keys[:, 1], hashing.EMPTY_HI)
    # One int64 key orders by (signed hi, signed lo); a second stable sort
    # moves invalid entries to the back, as jax.lax.sort(num_keys=3) on
    # (invalid, hi, lo) does.
    key = hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort((~valid[order]).to(torch.int8), stable=True)]
    lo_s, hi_s, valid_s = lo[order], hi[order], valid[order]

    prev_same = torch.zeros((n,), dtype=torch.bool, device=dev)
    prev_same[1:] = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    is_first = valid_s & ~prev_same
    uix = torch.cumsum(is_first.to(torch.int64), 0) - 1
    num_unique = is_first.sum().to(torch.int32)
    # invalid rows map to a trailing pad slot (count 0, EMPTY key)
    uix = torch.where(valid_s, uix, n - 1)

    unique_keys = torch.full((n, 2), hashing.EMPTY_LO, dtype=torch.int32,
                             device=dev)
    unique_keys[uix[is_first]] = torch.stack(
        [lo_s[is_first], hi_s[is_first]], dim=-1)
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    counts.index_add_(0, uix, valid_s.to(torch.int32))
    inverse = torch.empty((n,), dtype=torch.int32, device=dev)
    inverse[order] = uix.to(torch.int32)
    return UniqueResult(unique_keys, inverse, counts, num_unique)
