"""Multi-table packing: several logical embedding tables in one physical
KvTable.

Counterpart of ``tfplus_tpu/kv/multi.py`` (the reference's
MultiLevelHashMap, hashmap.h:776-1004: the logical table id in the high bits
of the 64-bit key, a 52-bit feature id below it). One physical table per
embedding dim turns a 26-table DCN step into 2 probe, gather and apply
passes; ``models.common.make_train_step_multi`` is that step.

Key layout: high 12 bits = logical table id, low 52 bits = feature id.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import hashing, table as kvt

TABLE_BITS = 12
PAYLOAD_BITS = 52
MAX_LOGICAL_TABLES = 1 << TABLE_BITS
_PAYLOAD_MASK = np.uint64((1 << PAYLOAD_BITS) - 1)
_HI_PAYLOAD_MASK = (1 << (PAYLOAD_BITS - 32)) - 1


def tag_ids(ids, logical_id: int):
    """Pack a logical-table id into the key's high bits.

    A numpy array of ids gives uint64 keys; a tensor (rank-1 raw ids, or
    encoded ``int32[N, 2]`` keys) gives encoded keys on its device with the
    tag in the high word. The high word is computed in int64 and wrapped to
    int32 (tags of 2048 and above set its sign bit), as the JAX package's
    uint32 arithmetic wraps. Tagging turns the EMPTY sentinel into an
    ordinary key: mask pad rows before tagging them."""
    if not 0 <= logical_id < MAX_LOGICAL_TABLES:
        raise ValueError(f"logical_id out of range: {logical_id}")
    if isinstance(ids, np.ndarray):
        u = ids.astype(np.uint64) & _PAYLOAD_MASK
        return (u | (np.uint64(logical_id) << np.uint64(PAYLOAD_BITS))
                ).astype(np.uint64)
    enc = hashing.encode_ids_raw(ids) if ids.ndim == 1 else ids
    hi = (hashing._u32(enc[..., 1]) & _HI_PAYLOAD_MASK) \
        | (logical_id << (PAYLOAD_BITS - 32))
    return torch.stack([enc[..., 0], hashing._i32(hi)], dim=-1)


def untag_ids_np(keys: np.ndarray):
    """Split exported uint64 keys back into (logical_id, feature_id)."""
    u = keys.astype(np.uint64)
    return ((u >> np.uint64(PAYLOAD_BITS)).astype(np.int32),
            (u & _PAYLOAD_MASK).astype(np.uint64))


class MultiTable:
    """N logical embedding tables (same dim) over one physical KvTable:
    register logical tables by name, look up with per-table id tagging.
    ``kv_kwargs`` go to :func:`kv.table.create` (``device`` among them)."""

    def __init__(self, dim: int, capacity: int = 1 << 16, **kv_kwargs):
        self.table = kvt.create(dim, capacity, **kv_kwargs)
        self._names: List[str] = []

    def register(self, name: str) -> int:
        if name in self._names:
            return self._names.index(name)
        if len(self._names) >= MAX_LOGICAL_TABLES:
            raise ValueError("too many logical tables")
        self._names.append(name)
        return len(self._names) - 1

    def logical_id(self, name: str) -> int:
        return self._names.index(name)

    def tag(self, name: str, ids):
        return tag_ids(ids, self.logical_id(name))

    def export_split(self) -> Dict[str, dict]:
        """Per-logical-table export: ``keys`` (feature ids), ``values`` and
        ``freq_values`` of each registered table."""
        ex = kvt.export_arrays(self.table)
        tids, fids = untag_ids_np(ex["keys"])
        out = {}
        for i, name in enumerate(self._names):
            sel = tids == i
            out[name] = {
                "keys": fids[sel],
                "values": ex["values"][sel],
                "freq_values": ex["freq_values"][sel],
            }
        return out
