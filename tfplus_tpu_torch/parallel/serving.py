"""Sharded serving: the shard-parallel ``lookup_or_zeros`` over f32 and int8
row-quantized tables, and per-shard delta refresh.

Counterpart of ``tfplus_tpu/parallel/serving.py``. Every rank holds one
table shard (the trainer's ``key % S`` routing) and answers its slice of a
query batch with the trainer's all-to-all exchange, inference only: no
counts, no insertion, read-only tables. A vocabulary too large for one
card serves from all of them, and int8 quantization puts 4x the rows on
each.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kv import hashing, quant as kvq, table as kvt, unique as kvu
from ..utils import device as _dev
from . import mesh as _mesh
from . import sharded_table as st


def _lookup_fn(table):
    """Owner-side read for one received key block: f32 or int8 table."""
    if isinstance(table, kvq.QuantKvTable):
        return kvq.lookup_or_zeros
    return kvt.lookup_or_zeros


def sharded_serving_lookup(table_local, ids, *, group=None,
                           bucket_capacity: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Per-rank body: inference lookup over this rank's shard, a
    ``KvTable`` or a ``QuantKvTable``. Unknown and blacklisted keys read
    zeros; the table is never changed.

    Returns ``(rows [B_l, D], route_overflow bool, needed_bucket_capacity
    int32)``; the last two are the group's max, the same on every rank, so
    that the caller can raise the bucket and ask again: a serving query
    never loses an id silently."""
    table = table_local
    S = dist.get_world_size(group)
    q = st._keys(ids, table.device)
    bl = q.shape[0]
    valid = torch.ones((bl,), dtype=torch.bool, device=q.device)
    cap = bucket_capacity or max(16, -(-bl * 2 // S))

    u = kvu.unique_with_counts(q, valid)
    uvalid = ~hashing.is_empty(u.unique_keys)
    owner = hashing.shard_of(u.unique_keys, S)
    dest, send_keys, overflow, max_dest = st._bucket(
        u.unique_keys, owner, uvalid, S, cap)
    route_overflow = _mesh.all_reduce(overflow.to(torch.int32), "max",
                                      group) > 0
    needed = _mesh.all_reduce(max_dest, "max", group)

    recv_keys = _mesh.all_to_all(send_keys, group)
    # read-only and duplicate-safe: no owner-side dedup; padding slots hold
    # EMPTY sentinels, which read as zeros
    own_rows = _lookup_fn(table)(table, recv_keys)
    back = _mesh.all_to_all(own_rows, group)
    return st._unbucket(back, dest, u.inverse), route_overflow, needed


def make_serving_lookup(table_local, group=None, *,
                        bucket_capacity: Optional[int] = None):
    """``fn(ids[B_l]) -> rows[B_l, D]`` over this rank's serving shard (f32
    ``KvTable`` or int8 ``QuantKvTable``); every rank calls it with its
    slice of the batch. Raises if the exchange bucket would drop an id:
    ask again with a larger ``bucket_capacity``."""
    def lookup(ids):
        rows, ovf, needed = sharded_serving_lookup(
            table_local, ids, group=group, bucket_capacity=bucket_capacity)
        if bool(ovf):
            raise RuntimeError(
                f"serving exchange bucket overflow — re-issue with "
                f"bucket_capacity >= {int(needed)}")
        return rows

    return lookup


def _uniform_capacity(rows: int, load_factor: float) -> int:
    cap = 64
    while cap * load_factor < max(rows, 1):
        cap *= 2
    return cap


def stack_shards(shards: Sequence, group=None):
    """This rank's shard of a list of per-shard tables (shard i for rank
    i), grown to the list's largest capacity so that every rank holds one
    capacity, as the JAX package's stacked layout needs. Quantized shards
    must share one capacity already (quantize AFTER sizing)."""
    caps = {s.capacity for s in shards}
    mine = shards[dist.get_rank(group)]
    if len(caps) != 1:
        if any(isinstance(s, kvq.QuantKvTable) for s in shards):
            raise ValueError(
                "quantized shards must share one capacity — re-load with "
                "uniform templates (quantize AFTER sizing)")
        if mine.capacity < max(caps):
            mine = kvt.grow(mine, max(caps))
    return mine


def load_for_serving_sharded(directory: str, group=None, *,
                             quantize: bool = False,
                             load_factor: float = 0.5, device=None):
    """Load an ``export_for_serving`` directory as this rank's shards: each
    table becomes a row-sharded (``key % S``) serving table, one shard per
    rank. The restore is elastic (the saver's repartition), so the export's
    shard count need not match the group's size; the capacity is one for
    every rank (computed from the bundle's row count alone).
    ``quantize=True`` stores int8 rows. When the export has one part per
    rank, each rank reads only its part; else each restores every shard
    and keeps its own. Collective: the ranks agree on
    the largest capacity a restore grew to. Returns ``(tables, metadata)``
    for :func:`sharded_serving_lookup`."""
    from ..checkpoint import bundle, saver
    from ..serving import RankingMetadata

    dev = _mesh.default_device() if device is None else _dev.resolve(device)
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    join = (lambda a, b: a.rstrip("/") + "/" + b)
    metadata = RankingMetadata.load(
        join(directory, "rank_service_embedding.json"))
    reader = bundle.BundleReader(join(directory, "serving"))
    tables = {}
    for col in metadata._columns:
        dim = col["embedding_dim"]
        names = [k[:-len("-keys")] for k in col["embedding_var_keys"]]
        var = names[0].split("/part_")[0]
        total = sum(reader.shape(n + "-keys")[0] for n in names)
        cap = _uniform_capacity(-(-total // S), load_factor)
        if len(names) == S:
            mine = saver.restore_table(reader, saver.shard_name(var, me, S),
                                       kvt.create(dim, cap, device=dev))
        else:
            tmpl = [kvt.create(dim, cap, device=dev) for _ in range(S)]
            mine = saver.restore(reader, {var: tmpl})[0][var][me]
        target = _mesh.host_max(mine.capacity, group, dev)
        if mine.capacity < target:          # grow BEFORE quantizing
            mine = kvt.grow(mine, target)
        tables[var] = kvq.quantize_table(mine) if quantize else mine
    return tables, metadata


def refresh_sharded_from_delta(tables: dict, delta_prefix: str, group=None,
                               *, quantize: bool = False) -> dict:
    """Apply a trainer's DELTA checkpoint to this rank's serving shards:
    online refresh without a full reload. The delta's shard count must
    equal the group's size (trainer and servers share ``key % S``; a change
    of topology takes a full reload): each rank upserts part ``rank`` of
    it into its shard. ``quantize`` must match how the tables were loaded
    (int8 shards are dequantized, upserted and quantized again, as
    ``serving.refresh_from_delta`` does)."""
    from .. import serving as _serving
    from ..checkpoint import bundle, saver

    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    reader = bundle.BundleReader(delta_prefix)
    return {name: _serving.refresh_shard(reader, saver.shard_name(name, me, S),
                                         t, quantize=quantize, name=name)
            for name, t in tables.items()}
