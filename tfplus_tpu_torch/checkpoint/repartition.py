"""Elastic repartition on restore: load a checkpoint written with M table
shards into N shards.

Counterpart of ``tfplus_tpu/checkpoint/repartition.py``. Keys route to
shards by ``key % num_shards`` with no renumbering, so a restore across a
shard-count change is a re-mod of the keyed rows; the optimizer slots live
in the table, so they move with their rows. Rows route chunk by chunk: each
source shard's values and slots stream through bounded host buffers
straight into the target shards. The target shards live on the templates'
device; no collectives are involved.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kv import hashing
from ..kv import table as kvt
from . import bundle, saver as _saver


def plan(ckpt_shards: int, want_shards: int) -> str:
    """The reference's restore-mode decision."""
    if ckpt_shards == want_shards:
        return "NORMAL"
    if want_shards == 1:
        return "MERGE"
    return "REPARTITION"


def _collect_small(reader, name: str, n_ckpt: int, suffix: str) -> np.ndarray:
    """Concatenate a SMALL control tensor (keys/blacklist/delete lists)
    across source shards — never used for values/slots."""
    parts = []
    for i in range(n_ckpt):
        key = _saver.shard_name(name, i, n_ckpt) + suffix
        if key in reader:
            parts.append(reader.lookup(key))
    if not parts:
        return np.zeros((0,), np.uint64)
    return np.concatenate(parts, axis=0)


def restore_repartitioned(reader: bundle.BundleReader, name: str,
                          templates: Sequence[kvt.KvTable], n_ckpt: int,
                          *, delta: bool = False,
                          chunk_rows: Optional[int] = None
                          ) -> List[kvt.KvTable]:
    """Read all M checkpoint shards of ``name`` and redistribute their rows
    into ``len(templates)`` shards by ``key % N``: NEW tables for a full
    restore, the templates themselves (upserted) for a delta. Deletes go
    first, then values chunk by chunk, then the slot rows."""
    n_want = len(templates)
    if delta:
        # incomplete delete lists must never be replayed (see restore_table)
        for i in range(n_ckpt):
            key = _saver.shard_name(name, i, n_ckpt) + "-need_full_import"
            if key in reader and int(np.asarray(reader.lookup(key))[0]):
                raise ValueError(
                    f"delta checkpoint shard {i} of '{name}' has "
                    "need_full_import=1 (deletion log overflowed) — "
                    "restore from a full checkpoint instead")

    blacklist = _collect_small(reader, name, n_ckpt, "-blacklist"
                               ).astype(np.uint64)
    delete_keys = _collect_small(reader, name, n_ckpt, "-delete_keys"
                                 ).astype(np.uint64)
    it_key = _saver.shard_name(name, 0, n_ckpt) + "-init_table"
    init_table = reader.lookup(it_key) if it_key in reader else None

    # target tables: fresh (a full restore clears) or the given templates
    out: List[kvt.KvTable] = []
    for template in templates:
        if delta:
            out.append(template)
            continue
        t = kvt.create(
            template.dim, template.capacity,
            initializer=(template.init_pool if init_table is None
                         else torch.from_numpy(np.array(init_table))),
            enter_threshold=template.config.enter_threshold,
            max_probes=template.config.max_probes,
            value_dtype=template.config.value_dtype,
            name=template.config.name, device=template.device)
        out.append(kvt.ensure_slots(t, dict(template.config.slot_layout)))

    if delete_keys.size:
        for i in range(n_want):
            dk = delete_keys[(delete_keys % np.uint64(n_want)
                              ).astype(np.int64) == i]
            if dk.size:
                qd = hashing.encode_ids_np_to_device(dk, out[i].device)
                out[i], _ = kvt.delete(out[i], qd)

    slot_suffixes = sorted({
        k.split("-slot-", 1)[1] for k in reader.keys()
        if k.startswith(name) and "-slot-" in k
    })

    # chunked routing: one source shard at a time, one value chunk at a time
    for s in range(n_ckpt):
        base = _saver.shard_name(name, s, n_ckpt)
        if base + "-keys" not in reader:
            continue
        keys = np.asarray(reader.lookup(base + "-keys")).astype(np.uint64)
        if not keys.size:
            continue
        meta = (np.asarray(reader.lookup(base + "-meta"))
                if base + "-meta" in reader else None)
        assign = (keys % np.uint64(n_want)).astype(np.int64)
        dim = out[0].dim
        cr = _saver._chunk_rows(dim * 4, chunk_rows)
        for start, vals in reader.stream(base + "-values", cr):
            rows = len(vals)
            ck = keys[start:start + rows]
            ca = assign[start:start + rows]
            for i in range(n_want):
                m = ca == i
                if not m.any():
                    continue
                sub: Dict[str, np.ndarray] = {"keys": ck[m], "values": vals[m]}
                if meta is not None:
                    sub["meta"] = meta[start:start + rows][m]
                if blacklist.size:
                    sub["blacklist"] = blacklist
                out[i] = kvt.import_arrays(out[i], sub, clear=False)
        # optimizer slot rows, same routing, streamed per chunk
        for sname in slot_suffixes:
            tname = base + "-slot-" + sname
            if tname not in reader:
                continue
            k = reader.shape(tname)[1] // dim
            scr = _saver._chunk_rows(k * dim * 4, chunk_rows)
            for start, rows_arr in reader.stream(tname, scr):
                ck = keys[start:start + len(rows_arr)]
                ca = assign[start:start + len(rows_arr)]
                for i in range(n_want):
                    m = ca == i
                    if not m.any():
                        continue
                    if sname not in out[i].config.slot_columns():
                        out[i] = kvt.ensure_slots(out[i], {sname: k})
                    fr = kvt.find(out[i], hashing.encode_ids_np_to_device(
                        ck[m], out[i].device))
                    out[i] = kvt.set_slot_rows(
                        out[i], sname, torch.where(fr.found, fr.slot, -1),
                        torch.from_numpy(rows_arr[m]))
    return out
