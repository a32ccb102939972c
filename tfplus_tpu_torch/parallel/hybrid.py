"""The host storage tier under sharded tables: per-shard spill and prefetch
between steps, so that a vocabulary that outgrows the cards' memory budget
keeps training.

Counterpart of ``tfplus_tpu/parallel/hybrid.py``. Protocol per step, as for
the single-table ``kv.storage.HybridTable``; every rank runs it with its own
shard and the SAME global batch of ids:

    hybrid.prefetch(global_ids)    # promote this rank's spilled rows of
                                   # the batch BEFORE the step (a missed
                                   # spilled id would re-insert as fresh)
    rows, state, hybrid.table = sharded_lookup(hybrid.table, ...)
    ...
    hybrid.maybe_spill(day=day)    # demote cold rows to the budget

Each rank keeps one :class:`~tfplus_tpu_torch.kv.storage.HostStorageTier`
for its shard and moves only the ids it owns (``key % S``). Both calls are
collective: after them the ranks agree on one capacity (the largest a
promotion grew to), as the JAX package's uniform ``shard_map`` shapes need.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ..kv import storage as kvs, table as kvt
from . import mesh as _mesh


class ShardedHybridTable:
    """Two-tier wrapper around this rank's shard: one host tier, spill and
    prefetch routed by the exchange's ``key % S``. Read ``.table`` anew
    after each call: a promotion that grew the shard replaces it."""

    def __init__(self, table: kvt.KvTable, group=None, *,
                 max_live_per_shard: Optional[int] = None,
                 min_freq: Optional[int] = None,
                 older_than_days: Optional[int] = None):
        self.table = table
        self.group = group
        self.num_shards = dist.get_world_size(group)
        self.shard_index = dist.get_rank(group)
        self.tier = kvs.HostStorageTier(table.dim, table.payload.shape[1],
                                        table.config.value_dtype)
        self.max_live_per_shard = max_live_per_shard
        self.min_freq = min_freq
        self.older_than_days = older_than_days

    def _agree_capacity(self) -> None:
        """Grow this shard to the largest capacity of the group."""
        target = _mesh.host_max(self.table.capacity, self.group,
                                self.table.device)
        if self.table.capacity < target:
            self.table = kvt.grow(self.table, target)

    def prefetch(self, ids) -> int:
        """Promote this rank's spilled rows of ``ids`` (the GLOBAL batch,
        the same on every rank) back into its shard, with values, slots and
        freq/day intact. Call BEFORE the step; collective. Returns the rows
        this rank promoted."""
        u64 = np.unique(kvs._ids_u64(ids))
        mine = u64[(u64 % np.uint64(self.num_shards)).astype(np.int64)
                   == self.shard_index]
        self.table, n = kvs.prefetch(self.table, self.tier, mine)
        self._agree_capacity()
        return n

    def maybe_spill(self, day: Optional[int] = None) -> int:
        """Demote cold rows of this rank's shard to its host tier until it
        fits ``max_live_per_shard`` (plus the freq/age policies). Call AFTER
        the step; collective. Returns the rows this rank spilled."""
        self.table, n = kvs.spill(
            self.table, self.tier, max_live=self.max_live_per_shard,
            min_freq=self.min_freq, older_than_days=self.older_than_days,
            day=day)
        self._agree_capacity()
        return n

    @property
    def logical_size(self) -> int:
        """Card + tier rows of THIS rank's shard (sum over the group for
        the global count)."""
        return int(kvt.size(self.table)) + self.tier.size

    def stats(self) -> dict:
        dev = int(kvt.size(self.table))
        return {"device_rows_per_shard": [dev],
                "tier_rows_per_shard": [self.tier.size],
                "local_shard_indices": [self.shard_index],
                "logical_size": dev + self.tier.size}
