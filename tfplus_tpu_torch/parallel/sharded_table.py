"""Row-sharded KV tables with the all-to-all lookup and gradient exchange.

Counterpart of ``tfplus_tpu/parallel/sharded_table.py``. Every rank owns
one hash-table shard of each table; ids go to their owner by
``key % num_shards`` (``kv.hashing.shard_of``), the reference's routing, so
checkpoints interoperate and re-shard.

The JAX package stacks the shards on a leading axis and runs the bodies
inside ``shard_map``. Here each rank holds its own shard as a plain
:class:`~tfplus_tpu_torch.kv.table.KvTable` (no leading axis) and calls the
same bodies, which take a process group (``group``, ``None`` = the default
group) in place of ``axis_name``. Per rank and step:

    local ids [B_l]
      └ dedup (unique_with_counts)                    — freq counted per example
      └ bucket by owner shard → send buffer [S·K]
      └ all_to_all ids + counts
      └ owner: dedup received ids (cross-rank dups) → lookup_or_insert
      └ rows routed back by the mirrored all_to_all
      └ unbucket → unique rows → batch rows via inverse

Gradients take the mirrored path: per-source-unique sums → all_to_all →
owner sums across sources → the fused optimizer update on the owner's rows.
Shapes are static per call: the per-destination bucket capacity K has an
overflow flag and a recovery path (:func:`dropped_positions`).

The owner-side row reads and writes run through the row kernels
(``kv.table``'s gathers and ``opt.apply``'s scatter), and both segment sums
through ``embedding._segment_sum``, which sums in a fixed order on the card.
The host helpers of the JAX package that take the stacked table
(``shard_sizes``, ``sharded_needs_grow``, ``sharded_grow``,
``grow_sharded_if_needed``) are collectives here: every rank calls them
with its own shard and every rank gets the same answer.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .. import embedding as _emb
from ..kv import hashing, table as kvt, unique as kvu
from ..optim.base import SparseOptimizer
from ..utils import device as _dev
from . import mesh as _mesh

Arr = torch.Tensor


def create_sharded(dim: int, capacity_per_shard: int, group=None, *,
                   device=None, **kwargs) -> kvt.KvTable:
    """This rank's shard of a sharded table: ``kv.create(dim,
    capacity_per_shard, **kwargs)`` on ``device`` (``cuda:<LOCAL_RANK>`` by
    default). Every rank's shard starts equal, as the JAX package broadcasts
    one base table to every shard; ``group`` takes the place of JAX's
    ``num_shards`` so that call sites keep their shape."""
    del group
    dev = _mesh.default_device() if device is None else _dev.resolve(device)
    return kvt.create(dim, capacity_per_shard, device=dev, **kwargs)


def init_optimizer_sharded(opt: SparseOptimizer,
                           sharded: kvt.KvTable) -> kvt.KvTable:
    """``opt.init`` of this rank's shard (adds the slot columns)."""
    return opt.init(sharded)


def local_shard(sharded: Union[kvt.KvTable, Sequence[kvt.KvTable]],
                index: int = 0) -> kvt.KvTable:
    """Shard ``index`` of a list of shards (one per rank, e.g. as a
    checkpoint restores them); a single table is the one shard this rank
    holds and comes back as it is."""
    if isinstance(sharded, (list, tuple)):
        return sharded[index]
    return sharded


class ExchangeState(NamedTuple):
    """Routing state threaded from sharded_lookup to sharded_apply_grads."""
    # source side
    src_inverse: Arr      # int32[B_l] batch position -> source-unique index
    src_valid: Arr        # bool[B_l]
    src_counts: Arr       # int32[B_l] multiplicity of each source-unique id
    dest: Arr             # int32[B_l] source-unique index -> send slot (S*K = drop)
    # owner side
    own_inverse: Arr      # int32[S*K] received position -> owner-unique index
    own_valid: Arr        # bool[S*K] received position carries a real id
    own_slot: Arr         # int32[S*K] owner-unique index -> table slot (-1 pad)
    own_counts: Arr       # int32[S*K] summed counts per owner-unique id
    # some id was dropped this step: route_overflow | table_overflow
    overflow: Arr
    # too many unique ids routed to one shard's bucket (this rank's sends):
    # raise bucket_capacity; growing the table cannot fix it
    route_overflow: Optional[Arr] = None
    # a key failed placement in the owner's table: grow the table
    table_overflow: Optional[Arr] = None
    # valid source-unique ids dropped by routing, summed over the group, and
    # the group's peak per-destination unique count: the least
    # bucket_capacity that routes everything (both the same on every rank)
    route_dropped: Optional[Arr] = None
    needed_bucket_capacity: Optional[Arr] = None
    # raw payload/meta rows of the owner-side lookup (train mode), handed to
    # the fused optimizer apply so it skips its gathers and (with
    # defer_meta) writes the lookup's freq/day/touch update in its meta write
    own_payload_rows: Optional[Arr] = None
    own_meta_rows: Optional[Arr] = None


def _bucket(keys: Arr, owner: Arr, valid: Arr, num_shards: int,
            cap: int) -> Tuple[Arr, Arr, Arr, Arr]:
    """Pack each key into its destination bucket slot.

    Returns (dest[N] flat index into [S*cap] or S*cap when dropped,
    send_keys[S*cap, 2], overflow bool, max_per_dest: the peak
    per-destination unique-id count, i.e. the least bucket_capacity that
    would NOT have overflowed)."""
    n = keys.shape[0]
    dev = keys.device
    total = num_shards * cap
    owner_s = torch.where(valid, owner, num_shards)
    order = torch.argsort(owner_s, stable=True)
    sorted_owner = owner_s[order]
    counts = torch.bincount(sorted_owner, minlength=num_shards + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[sorted_owner]
    routed = sorted_owner < num_shards
    ok = routed & (pos < cap)
    overflow = (routed & (pos >= cap)).any()
    flat = torch.where(ok, sorted_owner * cap + pos, total)
    dest = torch.empty((n,), dtype=torch.int64, device=dev)
    dest[order] = flat                 # dest in ORIGINAL (unsorted) order
    send = torch.full((total, 2), hashing.EMPTY_LO, dtype=torch.int32,
                      device=dev)
    keep = dest < total
    send[dest[keep]] = keys[keep]
    return (dest.to(torch.int32), send, overflow,
            counts[:num_shards].max().to(torch.int32))


def _keys(ids, device) -> Arr:
    """Raw ids (rank 1) or encoded keys [B, 2] as encoded keys."""
    if isinstance(ids, torch.Tensor) and ids.ndim == 2 and ids.shape[-1] == 2:
        return ids.to(device=device, dtype=torch.int32)
    return hashing.encode_ids_raw(ids, device).to(device)


def _unbucket(got: Arr, dest: Arr, inverse: Arr) -> Arr:
    """Rows that came back, [S*cap, D], to source-unique order (a dropped
    id, dest == S*cap, reads the zero pad row), then to batch order."""
    pad = got.new_zeros((1, got.shape[-1]))
    got = torch.cat([got, pad], dim=0)
    return got[dest.long()][inverse.long()]


def sharded_lookup(sharded_local: kvt.KvTable, ids, *, group=None,
                   train: bool = True, valid: Optional[Arr] = None,
                   day=0, bucket_capacity: Optional[int] = None,
                   defer_meta: bool = False, exchange_dtype=None,
                   ) -> Tuple[Arr, ExchangeState, kvt.KvTable]:
    """Per-rank body: ``ids`` is this rank's batch slice, rank-1 raw ids or
    ``[B, 2]`` encoded keys. Returns ``(batch_rows [B_l, D], state,
    table)``; the table is this rank's shard, updated in place.

    ``defer_meta=True`` (train mode): :func:`sharded_apply_grads` must
    follow over the returned state; the lookup's metadata write is done by
    the apply (one meta write per step).

    ``exchange_dtype`` (e.g. ``torch.bfloat16``) narrows the row payload of
    the owner→source all_to_all only; table state stays full precision. Pass
    the same dtype to :func:`sharded_apply_grads` for the gradients."""
    table = sharded_local
    S = dist.get_world_size(group)
    q = _keys(ids, table.device)
    bl = q.shape[0]
    if valid is None:
        valid = torch.ones((bl,), dtype=torch.bool, device=q.device)
    cap = bucket_capacity or max(16, -(-bl * 2 // S))   # 2x balanced load
    total = S * cap

    u = kvu.unique_with_counts(q, valid)
    uvalid = ~hashing.is_empty(u.unique_keys)
    owner = hashing.shard_of(u.unique_keys, S)
    dest, send_keys, overflow, max_dest = _bucket(u.unique_keys, owner,
                                                  uvalid, S, cap)
    route_dropped = _mesh.all_reduce(
        (uvalid & (dest == total)).sum().to(torch.int32), "sum", group)
    needed_cap = _mesh.all_reduce(max_dest, "max", group)
    send_counts = torch.zeros((total + 1,), dtype=torch.int32,
                              device=q.device)
    send_counts[dest.long()] = u.counts
    send_counts = send_counts[:total]

    # ids → owners (S chunks of cap, swapped over the group)
    recv_keys = _mesh.all_to_all(send_keys, group)
    recv_counts = _mesh.all_to_all(send_counts, group)

    # owner-side dedup (the same key may arrive from several source ranks)
    rvalid = ~hashing.is_free(recv_keys)
    ou = kvu.unique_with_counts(recv_keys, rvalid)
    ovalid = ~hashing.is_empty(ou.unique_keys)
    osum = torch.zeros((total,), dtype=torch.int32, device=q.device)
    osum.index_add_(0, ou.inverse.long(),
                    torch.where(rvalid, recv_counts, 0))

    route_overflow = overflow
    table_overflow = torch.zeros((), dtype=torch.bool, device=q.device)
    own_prow = own_mrow = None
    if train:
        res = kvt.lookup_or_insert(table, ou.unique_keys, counts=osum,
                                   valid=ovalid, day=day,
                                   defer_meta=defer_meta)
        own_rows, own_slot, table = res.rows, res.slot, res.table
        table_overflow = res.overflow
        overflow = overflow | res.overflow
        own_prow, own_mrow = res.payload_rows, res.meta_rows
    else:
        fr = kvt.find(table, ou.unique_keys, ovalid)
        own_rows = kvt._gather_rows(table, fr.slot, fr.found, fr.meta)
        own_slot = torch.where(fr.found, fr.slot, -1)

    # rows back to the sources (the mirrored exchange)
    back = own_rows[ou.inverse.long()]
    back = torch.where(rvalid[:, None], back, torch.zeros_like(back))
    wire = back.dtype
    if exchange_dtype is not None:
        back = back.to(exchange_dtype)            # narrow the wire only
    got = _mesh.all_to_all(back, group).to(wire)
    batch_rows = _unbucket(got, dest, u.inverse)
    batch_rows = torch.where(valid[:, None], batch_rows,
                             torch.zeros_like(batch_rows))

    state = ExchangeState(src_inverse=u.inverse, src_valid=valid,
                          src_counts=u.counts, dest=dest,
                          own_inverse=ou.inverse, own_valid=rvalid,
                          own_slot=own_slot, own_counts=osum,
                          overflow=overflow, route_overflow=route_overflow,
                          table_overflow=table_overflow,
                          route_dropped=route_dropped,
                          needed_bucket_capacity=needed_cap,
                          own_payload_rows=own_prow, own_meta_rows=own_mrow)
    return batch_rows, state, table


def dropped_positions(state: ExchangeState) -> Arr:
    """bool[B_l]: this rank's batch positions whose id was DROPPED by a
    route overflow this step (its owner's exchange bucket was full). They
    read zeros and contribute no gradient. Recovery: raise
    ``bucket_capacity`` to the state's ``needed_bucket_capacity`` and run
    the batch again with ``valid=dropped_positions(state)``, so that
    exactly the skipped ids contribute and frequency counts stay exact."""
    total = state.own_inverse.shape[0]          # S*cap
    dropped_unique = state.dest == total
    return dropped_unique[state.src_inverse.long()] & state.src_valid


def route_stats(state: ExchangeState, *, host: bool = True) -> dict:
    """One step's drop counts: valid unique ids dropped (summed over the
    group), the least bucket_capacity that routes everything (the group's
    max) and this rank's route-overflow flag; ``host=True`` gives ints."""
    out = {"route_dropped": state.route_dropped,
           "needed_bucket_capacity": state.needed_bucket_capacity,
           "route_overflow": state.route_overflow}
    if host:
        out = {k: (None if v is None else int(v)) for k, v in out.items()}
    return out


def sharded_apply_grads(opt: SparseOptimizer, sharded_local: kvt.KvTable,
                        state: ExchangeState, batch_grads: Arr, *,
                        group=None, lr, step, exchange_dtype=None,
                        ) -> kvt.KvTable:
    """Mirror path: per-position grads → sum to source uniques → all_to_all
    to owners → owner sum across sources → the fused sparse optimizer
    update of the owner's rows, in place.

    ``exchange_dtype`` narrows the gradient all_to_all: grads are summed per
    source BEFORE the wire and again in full precision on the owner, so the
    rounding applies once per (source, key) contribution."""
    table = sharded_local
    bl = batch_grads.shape[0]
    g = torch.where(state.src_valid[:, None], batch_grads,
                    torch.zeros_like(batch_grads))
    src_g = _emb._segment_sum(g, state.src_inverse.long(), bl)
    # to the owners at the ids' send slots (dest is unique but for drops)
    total = state.own_inverse.shape[0]          # S*cap
    send = _emb._segment_sum(src_g, state.dest.long(), total + 1)[:total]
    acc = send.dtype
    if exchange_dtype is not None:
        send = send.to(exchange_dtype)
    recv = _mesh.all_to_all(send, group).to(acc)
    own_g = _emb._segment_sum(
        torch.where(state.own_valid[:, None], recv, torch.zeros_like(recv)),
        state.own_inverse.long(), total)
    return opt.apply(table, state.own_slot, own_g, lr=lr, step=step,
                     payload_rows=state.own_payload_rows,
                     meta_rows=state.own_meta_rows)


# ---------------------------------------------------------------------------
# online growth of sharded tables
#
# Between steps, when any shard's overflow flag or load factor trips, every
# rank rehashes ITS OWN shard to one agreed UNIFORM capacity (routing is
# key % S and each shard rehashes its own keys, so no key moves between
# shards and no shard passes through the host). Sizes and lost-row counts
# are reduced over the group, and the grow target is a pure function of
# them, so every rank computes the same target.
# ---------------------------------------------------------------------------

def shard_sizes(sharded: kvt.KvTable, group=None) -> list:
    """Live row count of every rank's shard, in rank order (collective)."""
    n = kvt.size(sharded).reshape(1).to(torch.int64)
    return [int(c) for c in torch.cat(_mesh.all_gather(n, group)).tolist()]


def sharded_needs_grow(sharded: kvt.KvTable, incoming_per_shard: int = 0, *,
                       threshold: float = kvt.GROW_LOAD_FACTOR,
                       overflow=None, group=None) -> bool:
    """Does ANY shard need to grow? (collective, same answer everywhere).

    ``overflow``: this rank's ``state.table_overflow``; a flag tripped on
    any rank forces growth (an id failed placement; after growth the next
    lookup of that id inserts it). Do NOT pass the union ``state.overflow``:
    a route overflow means a bucket was full, which growing cannot fix."""
    trip = (overflow is not None
            and _mesh.any_true(overflow, group, sharded.device))
    hi = max(shard_sizes(sharded, group))
    return trip or (hi + incoming_per_shard) > threshold * sharded.capacity


def uniform_grow_target(hi: int, old_cap: int, incoming: int,
                        threshold: float) -> int:
    """Doublings of ``old_cap`` until ``hi + incoming`` rows fit under the
    load-factor ``threshold``. A pure function of values every rank
    shares, so every rank computes the same target."""
    target = old_cap * 2
    while hi + incoming > threshold * target:
        target *= 2
    return target


def _grow_verified(sharded: kvt.KvTable, target: int,
                   group=None) -> kvt.KvTable:
    """Every rank rebuilds its shard at ``target``; if ANY shard lost rows to
    a pathological bucket-pair collision, every rank doubles the uniform
    target and rebuilds from its ORIGINAL shard (at most 5 times), so that
    capacities stay equal. ``group``: every rank that shares the
    capacity (the whole mesh in 2D)."""
    if target & (target - 1):
        raise ValueError("per-shard capacity must be a power of two")
    if target < sharded.capacity:
        raise ValueError("cannot shrink below current capacity")
    for _ in range(5):
        grown, lost = kvt._rehash_core_fast(sharded, target)
        lost = _mesh.host_sum(lost, group)
        if lost == 0:
            return grown
        del grown
        target *= 2
    raise RuntimeError(
        f"sharded rehash lost {lost} rows even at {target // 2} capacity "
        "per shard — pathological bucket collisions")


def sharded_grow(sharded: kvt.KvTable,
                 new_capacity_per_shard: Optional[int] = None, *,
                 incoming_per_shard: int = 0,
                 threshold: float = kvt.GROW_LOAD_FACTOR,
                 group=None) -> kvt.KvTable:
    """Grow every shard to one UNIFORM new capacity (collective; a NEW
    table). The target is 2x, or more doublings when
    ``incoming_per_shard`` new rows would still pass the load-factor
    threshold at 2x. Shard membership never changes (routing stays
    ``key % S``); only each shard's slot placement is rebuilt, on its own
    rank's device."""
    target = new_capacity_per_shard
    if target is None:
        target = uniform_grow_target(max(shard_sizes(sharded, group)),
                                     sharded.capacity, incoming_per_shard,
                                     threshold)
    return _grow_verified(sharded, target, group)


def grow_sharded_if_needed(tables: Dict[str, kvt.KvTable], *,
                           incoming_per_shard: int = 0,
                           threshold: float = kvt.GROW_LOAD_FACTOR,
                           overflow=None, group=None
                           ) -> Tuple[Dict[str, kvt.KvTable], bool]:
    """Between-steps growth sweep over a dict of this rank's shards (the
    distributed analogue of ``models.grow_if_needed``; collective). Returns
    ``(tables, grew)``; sizes are gathered once per table and reused for
    the target."""
    dev = next(iter(tables.values())).device if tables else None
    trip = overflow is not None and _mesh.any_true(overflow, group, dev)
    out, grew = dict(tables), False
    for name, t in tables.items():
        hi = max(shard_sizes(t, group))
        if trip or (hi + incoming_per_shard) > threshold * t.capacity:
            target = uniform_grow_target(hi, t.capacity, incoming_per_shard,
                                         threshold)
            out[name] = sharded_grow(t, target, group=group)
            grew = True
    return out, grew


def sharded_embedding_lookup_sparse(sharded_local: kvt.KvTable, ids,
                                    segment_ids, num_segments: int, *,
                                    weights: Optional[Arr] = None,
                                    valid: Optional[Arr] = None,
                                    combiner: str = "mean", group=None,
                                    train: bool = True, day=0,
                                    defer_meta: bool = False,
                                    exchange_dtype=None):
    """COO sparse lookup and combine over the sharded table (per-rank body;
    the distributed analogue of ``embedding.embedding_lookup_sparse``).
    ``ids[N]`` / ``segment_ids[N]`` / ``valid[N]`` are this rank's COO
    slice; segments index this rank's LOCAL batch rows. Returns
    ``(combined [num_segments, D], state, table)``. For training, take the
    per-position rows of :func:`sharded_lookup`, combine them in the loss
    with ``embedding.combine_rows`` and apply their gradients with
    :func:`sharded_apply_grads`."""
    rows, state, table = sharded_lookup(
        sharded_local, ids, group=group, train=train, valid=valid, day=day,
        defer_meta=defer_meta, exchange_dtype=exchange_dtype)
    seg = torch.as_tensor(segment_ids, dtype=torch.int32, device=rows.device)
    out = _emb.combine_rows(rows, seg, num_segments,
                            valid=state.src_valid if valid is None else valid,
                            weights=weights, combiner=combiner)
    return out, state, table
