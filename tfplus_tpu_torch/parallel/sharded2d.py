"""2D sparse parallelism: tables sharded by ROWS x COLUMNS over a 2D mesh.

Counterpart of ``tfplus_tpu/parallel/sharded2d.py``. Splitting each row's D
columns over a second mesh dim divides the row exchange's volume (B·D
floats per rank) by C, the "two-dimensional sparse parallelism" design
(arXiv:2508.03854), on a ``DeviceMesh`` with dims ("row", "col").

Layout: rank (r, c) holds an ORDINARY :class:`KvTable` with ``dim_local =
D / C``: rows routed ``key % R`` (dim "row"), columns ``[c·D/C,
(c+1)·D/C)`` (dim "col"). Headers (keys and packed meta) are the same on
every col rank and kept in lockstep BY CONSTRUCTION: every input that
changes a header (ids, counts, the group-lasso keep/blacklist decision) is
the same across the col ranks: ids through a col all_gather before the
row exchange, the lasso decision through a group norm all-reduced over the
col group (``Rule.norm_axis``, set by :func:`for_col_axis`).

Exchange per step on rank (r, c), local batch b = B / (R·C):
  1. all_gather ids over "col"      → the col group's union batch [C·b]
  2. row exchange (``sharded_table.sharded_lookup`` over the row group):
     the same on every col rank; the union batch's rows at THIS slice
  3. all_to_all over "col" turns (batch of rank j, my slice) into
     (my batch, slice of rank j) → concatenated to [b, D]
Gradients go back 3 → 2 → 1 with segment sums at each hop.

Bodies take the mesh and its dim names; the mesh must span every rank of
the default group (the growth helpers reduce over all of them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kv import table as kvt
from ..optim.base import SparseOptimizer
from ..utils import device as _dev
from . import mesh as _mesh
from . import sharded_table as st

ROW_AXIS = "row"
COL_AXIS = "col"


def make_mesh_2d(num_rows: int, num_cols: int, row_axis: str = ROW_AXIS,
                 col_axis: str = COL_AXIS, device_type: str = "cuda"):
    """A (num_rows, num_cols) ``DeviceMesh`` over every rank (collective)."""
    from torch.distributed.device_mesh import init_device_mesh
    if num_rows * num_cols != dist.get_world_size():
        raise ValueError(f"a {num_rows} x {num_cols} mesh in a world of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (num_rows, num_cols),
                            mesh_dim_names=(row_axis, col_axis))


def _groups(mesh, row_axis: str, col_axis: str):
    return mesh.get_group(row_axis), mesh.get_group(col_axis)


def create_sharded_2d(dim: int, capacity_per_row_shard: int, mesh, *,
                      row_axis: str = ROW_AXIS, col_axis: str = COL_AXIS,
                      initializer=None, device=None, **kwargs) -> kvt.KvTable:
    """This rank's (r, c) shard: an ordinary ``dim / C``-wide table.
    ``initializer``: an optional full-dim init pool [P, dim], sliced to this
    rank's columns so that 2D lookups give a full-width table's init rows
    exactly."""
    _, col_group = _groups(mesh, row_axis, col_axis)
    C = dist.get_world_size(col_group)
    c = dist.get_rank(col_group)
    if dim % C:
        raise ValueError(f"dim {dim} must divide num_cols {C}")
    d_l = dim // C
    init_c = None
    if initializer is not None:
        init_c = torch.as_tensor(initializer)[:, c * d_l:(c + 1) * d_l]
    dev = _mesh.default_device() if device is None else _dev.resolve(device)
    return kvt.create(d_l, capacity_per_row_shard, initializer=init_c,
                      device=dev, **kwargs)


def init_optimizer_sharded_2d(opt: SparseOptimizer,
                              sharded: kvt.KvTable) -> kvt.KvTable:
    """Adds the slot columns (width k·dim_local on each col shard)."""
    return opt.init(sharded)


def for_col_axis(opt: SparseOptimizer, mesh,
                 col_axis: str = COL_AXIS) -> SparseOptimizer:
    """A group-lasso optimizer for dim-sharded rows: its l21 group norm and
    blacklist decision reduce over the col group of ``mesh`` (a
    ``DeviceMesh``, or the col process group itself), the same on every
    column shard. Rules without ``norm_axis`` come back unchanged."""
    if not hasattr(opt.rule, "norm_axis"):
        return opt
    group = mesh.get_group(col_axis) if hasattr(mesh, "get_group") else mesh
    return dataclasses.replace(
        opt, rule=dataclasses.replace(opt.rule, norm_axis=group))


def _col_swap(x: torch.Tensor, col_group, exchange_dtype) -> torch.Tensor:
    """all_to_all of [C·b, d] over the col group, on an optionally narrower
    wire."""
    acc = x.dtype
    if exchange_dtype is not None:
        x = x.to(exchange_dtype)
    return _mesh.all_to_all(x, col_group).to(acc)


def sharded_lookup_2d(sharded_local: kvt.KvTable, ids, *, mesh,
                      row_axis: str = ROW_AXIS, col_axis: str = COL_AXIS,
                      train: bool = True,
                      valid: Optional[torch.Tensor] = None,
                      day=0, bucket_capacity: Optional[int] = None,
                      defer_meta: bool = False, exchange_dtype=None,
                      ) -> Tuple[torch.Tensor, st.ExchangeState,
                                 kvt.KvTable]:
    """Per-rank body: ``ids`` is this rank's batch slice. Returns ``(rows
    [b, D], state, table)`` with D the FULL dim."""
    table = sharded_local
    row_group, col_group = _groups(mesh, row_axis, col_axis)
    C = dist.get_world_size(col_group)
    q = st._keys(ids, table.device)
    b = q.shape[0]
    # 1. the col group's union batch (the same on every col rank)
    union_q = torch.cat(_mesh.all_gather(q, col_group))
    union_valid = None
    if valid is not None:
        v = torch.as_tensor(valid, device=q.device).to(torch.uint8)
        union_valid = torch.cat(_mesh.all_gather(v, col_group)).bool()
    # 2. row exchange: the same on every col rank; headers change in step
    rows_u, state, table = st.sharded_lookup(
        table, union_q, group=row_group, train=train, valid=union_valid,
        day=day, bucket_capacity=bucket_capacity, defer_meta=defer_meta,
        exchange_dtype=exchange_dtype)
    d_l = rows_u.shape[-1]
    # 3. col transpose: (rank-j batch, my slice) -> (my batch, rank-j slice)
    r = _col_swap(rows_u, col_group, exchange_dtype).view(C, b, d_l)
    rows = r.permute(1, 0, 2).reshape(b, C * d_l)
    return rows, state, table


def sharded_apply_grads_2d(opt: SparseOptimizer, sharded_local: kvt.KvTable,
                           state: st.ExchangeState, batch_grads, *, mesh,
                           row_axis: str = ROW_AXIS,
                           col_axis: str = COL_AXIS,
                           lr, step, exchange_dtype=None) -> kvt.KvTable:
    """Mirror path: grads [b, D] → col all_to_all to (union batch, my
    slice) → row exchange → fused owner update. ``opt`` must come from
    :func:`for_col_axis` when the rule is group-lasso."""
    row_group, col_group = _groups(mesh, row_axis, col_axis)
    C = dist.get_world_size(col_group)
    b = batch_grads.shape[0]
    d_l = batch_grads.shape[-1] // C
    g = batch_grads.reshape(b, C, d_l).permute(1, 0, 2).reshape(C * b, d_l)
    union_g = _col_swap(g, col_group, exchange_dtype)   # all_gather order
    return st.sharded_apply_grads(opt, sharded_local, state, union_g,
                                  group=row_group, lr=lr, step=step,
                                  exchange_dtype=exchange_dtype)


def local_shard_2d(sharded, r: int, c: int) -> kvt.KvTable:
    """Shard (r, c) of a nested list of shards; a single table is the one
    shard this rank holds and comes back as it is."""
    if isinstance(sharded, (list, tuple)):
        return sharded[r][c]
    return sharded


def combine_col_shards(sharded_local: kvt.KvTable, mesh, *,
                       col_axis: str = COL_AXIS) -> kvt.KvTable:
    """Fold the col dim away (collective over the col group): this rank's
    row of shards as one full-dim table, for checkpointing with the
    ordinary saver. The payload keeps the ``[values | slot0 | slot1 ...]``
    layout at full dim: the column blocks are interleaved segment by
    segment."""
    t = sharded_local
    col_group = mesh.get_group(col_axis)
    payloads = _mesh.all_gather(t.payload, col_group)
    pools = _mesh.all_gather(t.init_pool, col_group)
    d_l = t.config.dim
    k = t.payload.shape[-1] // d_l                # 1 + Σ slot widths
    segs = [torch.cat([p[:, s * d_l:(s + 1) * d_l] for p in payloads], -1)
            for s in range(k)]
    cfg = dataclasses.replace(t.config, dim=d_l * len(payloads))
    return dataclasses.replace(t, config=cfg, payload=torch.cat(segs, -1),
                               init_pool=torch.cat(pools, -1))


# ---------------------------------------------------------------------------
# online growth of row x col sharded tables
#
# As sharded_table.sharded_grow: between steps every (r, c) rank rehashes
# its OWN shard's row capacity to one agreed uniform target. Column
# lockstep survives growth for free: every col rank of a row holds the same
# keys, and the rehash's placement is a pure function of (keys, capacity).
# ---------------------------------------------------------------------------

def _check_world(mesh) -> None:
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("the 2D growth helpers need a mesh over every rank")


def shard_sizes_2d(sharded_local: kvt.KvTable, mesh) -> list:
    """[R][C] live-row counts (collective over the whole mesh)."""
    _check_world(mesh)
    by_rank = st.shard_sizes(sharded_local)
    return [[by_rank[int(g)] for g in row] for row in mesh.mesh.tolist()]


def sharded_needs_grow_2d(sharded_local: kvt.KvTable, mesh,
                          incoming_per_shard: int = 0, *,
                          threshold: float = kvt.GROW_LOAD_FACTOR,
                          overflow=None) -> bool:
    """Does ANY (r, c) shard need to grow? A ``table_overflow`` tripped on
    any rank forces growth (collective, same answer everywhere). The
    [R][C] grid's maximum is the default group's, so this is
    ``sharded_table.sharded_needs_grow`` over every rank."""
    _check_world(mesh)
    return st.sharded_needs_grow(sharded_local, incoming_per_shard,
                                 threshold=threshold, overflow=overflow)


def sharded_grow_2d(sharded_local: kvt.KvTable, mesh,
                    new_capacity_per_shard: Optional[int] = None, *,
                    incoming_per_shard: int = 0,
                    threshold: float = kvt.GROW_LOAD_FACTOR) -> kvt.KvTable:
    """Grow every (r, c) shard to one UNIFORM row capacity and rehash
    (collective; a NEW table). Row routing stays ``key % R``; col slices
    and header lockstep are kept (see the note above)."""
    _check_world(mesh)
    return st.sharded_grow(sharded_local, new_capacity_per_shard,
                           incoming_per_shard=incoming_per_shard,
                           threshold=threshold)


def grow_sharded_2d_if_needed(tables: dict, mesh, *,
                              incoming_per_shard: int = 0,
                              threshold: float = kvt.GROW_LOAD_FACTOR,
                              overflow=None):
    """Between-steps growth sweep over a dict of this rank's 2D shards
    (collective). Returns ``(tables, grew)``."""
    _check_world(mesh)
    return st.grow_sharded_if_needed(tables,
                                     incoming_per_shard=incoming_per_shard,
                                     threshold=threshold, overflow=overflow)
