"""Embedding lookups over KvTables.

Counterpart of ``tfplus_tpu/embedding.py``: dedup → one table lookup
(inserting on miss when training) → inverse-index take, whose backward sums
duplicate ids' gradients into the unique rows.
Ragged inputs stay fixed-size ``[N]`` with a validity mask, as in the JAX
package. The combiners and the ``*_sparse`` variants are not ported yet.
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
