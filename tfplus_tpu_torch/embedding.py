"""Embedding lookups over KvTables.

Counterpart of ``tfplus_tpu/embedding.py``: dedup → one table lookup
(inserting on miss when training) → inverse-index take, whose backward sums
duplicate ids' gradients into the unique rows.
Ragged inputs stay fixed-size ``[N]`` with a validity mask, as in the JAX
package: a sparse batch is the COO triple ``(ids[N], segment_ids[N],
valid[N])``, and the combiners (sum, mean, sqrtn, weighted or not) reduce it
to ``[num_segments, D]``.

Segment sums run in a fixed order, so a rerun is bit-identical: on the card
through ``index_put_(accumulate=True)``, which sorts the indices, and on the
CPU through ``index_add_``, which adds serially. The JAX package's
``segment_sum`` adds in an order of its own, so the two agree to float32
rounding, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .kv import hashing, table as kvt, unique as kvu


def _canon_ids(ids, device) -> torch.Tensor:
    """rank-1 input = raw ids (encode); rank-2 ``[N, 2]`` int32 = already
    encoded (passthrough); host int64/uint64 arrays = raw (split words).
    Host inputs and tensors on another device go to ``device``."""
    if isinstance(ids, np.ndarray) and ids.dtype in (np.int64, np.uint64):
        return hashing.encode_ids(ids, device)
    arr = torch.as_tensor(ids, device=device) if not isinstance(
        ids, torch.Tensor) else ids.to(device)
    if arr.ndim == 1:
        return hashing.encode_ids_raw(arr)
    if arr.ndim == 2 and arr.shape[-1] == 2 and arr.dtype == torch.int32:
        return arr
    raise ValueError(f"ids must be rank-1 raw or [N,2] encoded, got "
                     f"{tuple(arr.shape)}")


class Lookup(NamedTuple):
    """Result of a deduplicated table lookup (N = input size)."""
    rows: torch.Tensor         # [N, D] unique rows (pads/blacklist = zeros)
    slot: torch.Tensor         # int32[N] physical slots (-1 pad)
    inverse: torch.Tensor      # int32[N] input position -> unique row index
    counts: torch.Tensor       # int32[N] multiplicity per unique row
    valid: torch.Tensor        # bool[N] validity of each *input* position
    num_unique: torch.Tensor   # int32 scalar
    payload_rows: Optional[torch.Tensor] = None
    meta_rows: Optional[torch.Tensor] = None


def lookup_unique(table: kvt.KvTable, ids, *, train: bool = True,
                  valid: Optional[torch.Tensor] = None,
                  day=0,
                  defer_meta: bool = False):
    """Dedup ids then gather (inserting on miss when training). Returns
    ``(Lookup, table)``; eval mode never mutates, train mode updates the
    table in place."""
    q = _canon_ids(ids, table.device)
    n = q.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=q.device)
    u = kvu.unique_with_counts(q, valid)
    uvalid = ~hashing.is_empty(u.unique_keys)
    if train:
        res = kvt.lookup_or_insert(table, u.unique_keys, counts=u.counts,
                                   valid=uvalid, day=day,
                                   defer_meta=defer_meta)
        rows, slot, table = res.rows, res.slot, res.table
        prow, mrow = res.payload_rows, res.meta_rows
    else:
        fr = kvt.find(table, u.unique_keys, uvalid)
        rows = kvt._gather_rows(table, fr.slot, fr.found, fr.meta)
        slot = torch.where(fr.found, fr.slot, -1)
        prow = mrow = None
    return (Lookup(rows=rows, slot=slot, inverse=u.inverse, counts=u.counts,
                   valid=valid, num_unique=u.num_unique,
                   payload_rows=prow, meta_rows=mrow), table)


class _TakeRows(torch.autograd.Function):
    """``rows[idx]`` whose backward sums the gradients of duplicate indices
    in a fixed order, so a training step reruns bit for bit (the JAX
    transpose of the take is a deterministic segment sum). Autograd's own
    backward of indexing is ``index_put_(accumulate=True)``, which is
    sort-based and deterministic on the card but adds with atomics from
    several threads on the CPU; ``index_add_`` adds serially there."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = rows.shape[0]
        return rows[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        out = grad.new_zeros((ctx.num_rows,) + grad.shape[1:])
        if grad.is_cuda:
            out.index_put_((idx,), grad, accumulate=True)
        else:
            out.index_add_(0, idx, grad)
        return out, None


def gather(look: Lookup, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expand unique rows back to input order: ``out[i] = rows[inverse[i]]``
    (zeros at invalid positions). Pass ``rows`` explicitly when gradients
    must flow to them."""
    rows = look.rows if rows is None else rows
    out = _TakeRows.apply(rows, look.inverse.long())
    return torch.where(look.valid[:, None], out, torch.zeros_like(out))


def embedding_lookup(table: kvt.KvTable, ids, *, train: bool = True,
                     valid: Optional[torch.Tensor] = None,
                     day=0):
    """Dense lookup: RAW ``ids`` of any shape → ``[..., D]``. A 2-D input is
    a batch of raw ids, never pre-encoded keys (use :func:`lookup_unique`).
    Returns ``(embeddings, Lookup, table)``."""
    ids_arr = hashing.encode_ids_raw(ids, table.device).to(table.device)
    batch_shape = ids_arr.shape[:-1]
    flat = ids_arr.reshape(-1, 2)
    if valid is not None:
        valid = valid.reshape(-1)
    look, table = lookup_unique(table, flat, train=train, valid=valid, day=day)
    emb = gather(look).reshape(*batch_shape, table.dim)
    return emb, look, table


def _segment_sum(x: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``out[s] = Σ x[i] over seg[i] == s`` in a fixed order (see the module
    docstring); differentiable with respect to ``x``."""
    out = x.new_zeros((num_segments,) + x.shape[1:])
    if x.is_cuda:
        return out.index_put_((seg,), x, accumulate=True)
    return out.index_add_(0, seg, x)


def _on(x, device, dtype=None) -> torch.Tensor:
    """A host array or a tensor as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


_COMBINERS = ("sum", "mean", "sqrtn")


def combine(look: Lookup, segment_ids: torch.Tensor, num_segments: int,
            rows: Optional[torch.Tensor] = None,
            weights: Optional[torch.Tensor] = None,
            combiner: str = "mean") -> torch.Tensor:
    """Segment-combine looked-up rows into ``[num_segments, D]``: sum, mean
    (Σwx/Σw) or sqrtn (Σwx/√Σw²), with unit weights when ``weights`` is
    None. Differentiable with respect to ``rows`` and ``weights``."""
    rows = look.rows if rows is None else rows
    x = _TakeRows.apply(rows, look.inverse.long())      # [N, D] input order
    return combine_rows(x, segment_ids, num_segments, valid=look.valid,
                        weights=weights, combiner=combiner)


def combine_rows(x: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *,
                 valid: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None,
                 combiner: str = "mean") -> torch.Tensor:
    """The combiner over per-position rows ``x [N, D]`` (already in input
    order). Invalid positions go to an extra segment that is dropped.
    Differentiable with respect to ``x`` and ``weights``."""
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be one of {_COMBINERS}")
    n, dev = x.shape[0], x.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    w = (torch.ones((n,), dtype=x.dtype, device=dev) if weights is None
         else _on(weights, dev, x.dtype))
    w = torch.where(valid, w, 0.0)
    seg = torch.where(valid, _on(segment_ids, dev).long(), num_segments)
    num = _segment_sum(x * w[:, None], seg, num_segments + 1)[:-1]
    if combiner == "sum":
        return num
    if combiner == "mean":
        den = _segment_sum(w, seg, num_segments + 1)[:-1]
    else:
        den = torch.sqrt(_segment_sum(w * w, seg, num_segments + 1)[:-1])
    return num / torch.clamp(den, min=1e-12)[:, None]


def embedding_lookup_sparse(table: kvt.KvTable, ids, segment_ids,
                            num_segments: int, *,
                            weights: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None,
                            combiner: str = "mean", train: bool = True,
                            day=0):
    """COO sparse lookup and combine: ``ids[N]`` with ``segment_ids[N]``
    (the output row of each id, in any order) and a ``valid[N]`` padding
    mask → ``[num_segments, D]``. Returns ``(combined, Lookup, table)``."""
    look, table = lookup_unique(table, ids, train=train, valid=valid, day=day)
    out = combine(look, _on(segment_ids, table.device, torch.int32),
                  num_segments, weights=weights, combiner=combiner)
    return out, look, table


def safe_embedding_lookup_sparse(table: kvt.KvTable, ids, segment_ids,
                                 num_segments: int, *,
                                 weights: Optional[torch.Tensor] = None,
                                 valid: Optional[torch.Tensor] = None,
                                 combiner: str = "mean", train: bool = True,
                                 default_id: Optional[int] = None,
                                 prune_negative: bool = True,
                                 day=0):
    """:func:`embedding_lookup_sparse` that prunes invalid entries first:
    negative ids (the sign is the encoded high word's) and weights <= 0.
    Output rows left with no entry get the ``default_id`` row, or zeros.
    Raw ``uint64`` numpy ids are never pruned for their sign: their top bit
    is part of the key (string fingerprints span all 64 bits); pass
    ``prune_negative=False`` for pre-encoded keys of that kind."""
    dev = table.device
    q = _canon_ids(ids, dev)
    n = q.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else _on(valid, dev, torch.bool))
    if prune_negative and not (isinstance(ids, np.ndarray)
                               and ids.dtype == np.uint64):
        valid = valid & (q[:, 1] >= 0)
    if weights is not None:
        weights = _on(weights, dev)
        valid = valid & (weights > 0)
    seg = _on(segment_ids, dev, torch.int32)
    out, look, table = embedding_lookup_sparse(
        table, q, seg, num_segments, weights=weights, valid=valid,
        combiner=combiner, train=train, day=day)
    present = _segment_sum(valid.to(torch.int32),
                           torch.where(valid, seg, num_segments).long(),
                           num_segments + 1)[:-1]
    empty = (present == 0)[:, None]
    if default_id is not None:
        dq = hashing.encode_ids_np_to_device(
            np.array([default_id], np.int64), dev)
        out = torch.where(empty, kvt.lookup_or_zeros(table, dq)[0][None, :],
                          out)
    else:
        out = torch.where(empty, torch.zeros_like(out), out)
    return out, look, table


def grads_to_unique(look: Lookup,
                    grad_per_position: torch.Tensor) -> torch.Tensor:
    """Sum per-input-position gradients onto the unique rows (invalid
    positions contribute nothing), in a fixed order."""
    g = torch.where(look.valid[:, None], grad_per_position,
                    torch.zeros_like(grad_per_position))
    return _segment_sum(g, look.inverse.long(), look.inverse.shape[0])


def partitioned_lookup(shards, ids, *, train: bool = True, day=0):
    """Dense lookup over a PartitionedVariable-style shard list, routing by
    ``key % num_shards``. ``shards``: list of KvTable or a single table.
    Returns ``(rows [..., D], shards)``."""
    if isinstance(shards, kvt.KvTable):
        rows, _, t = embedding_lookup(shards, ids, train=train, day=day)
        return rows, t
    dev = shards[0].device
    ids_arr = hashing.encode_ids_raw(ids, dev).to(dev)
    batch_shape = ids_arr.shape[:-1]
    flat = ids_arr.reshape(-1, 2)
    owner = hashing.shard_of(flat, len(shards))
    dim = shards[0].config.dim
    out = torch.zeros((flat.shape[0], dim), dtype=shards[0].payload.dtype,
                      device=dev)
    new_shards = []
    for s, t in enumerate(shards):
        mine = owner == s
        # every shard processes the full batch with a validity mask
        look, t = lookup_unique(t, flat, train=train, valid=mine, day=day)
        out = torch.where(mine[:, None], gather(look), out)
        new_shards.append(t)
    return out.reshape(*batch_shape, dim), new_shards
