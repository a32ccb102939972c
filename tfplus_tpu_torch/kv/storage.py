"""Hybrid embedding storage: a host-DRAM tier for cold rows.

Counterpart of ``tfplus_tpu/kv/storage.py`` (the reference's storage-tier
machinery, ``hybrid_embedding/storage_table.h:41-71`` and
``table_manager.h:45-544``), so that one logical table can outgrow the
card's memory:

  * the device-resident :class:`~tfplus_tpu_torch.kv.table.KvTable` is the
    hot tier: every lookup and update of a step touches only it;
  * :class:`HostStorageTier` is a host-side numpy arena of spilled rows
    (full payload with the optimizer's slot columns, and the packed meta
    word), keyed by uint64 id;
  * tier moves run on the host between steps: :func:`spill` demotes cold
    rows (by frequency, age or a live-row budget) and :func:`prefetch`
    promotes the next batch's ids back to the card before the step, so the
    step never misses a row that exists.

Invariant: a key lives in exactly ONE tier. Checkpoints are tier-agnostic:
:func:`export_hybrid_arrays` merges both tiers into the logical tensors of
``kv.table.export_arrays`` and :func:`restore_hybrid_split` splits them again
by frequency.

The port's tables update in place: :func:`_drop_rows` writes tombstones
into the table's own header, and :func:`spill` and :func:`prefetch` return
``(table, n)`` as the JAX package's do (``prefetch`` returns a NEW table when
it had to grow). Device rows move through the row kernels: the spill's
gather of the victims' payload rows and the export's gather of slot rows
are ``ops.rowops.gather_rows`` (one launch each), a promotion's writes
``kv.table.insert_raw`` (one ``scatter_rows`` each). ``spill`` reads the
whole key and meta planes back to the host on every call, as the JAX
package does. A bfloat16 table's spilled rows are held as their 16-bit
patterns (numpy ``uint16``; numpy has no bfloat16), the JAX tier's bytes,
and turn back into bfloat16 tensors, or exact float32 for an export, where
they leave the tier.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import hashing
from . import table as kvt
from ..ops import rowops
from ..utils import packing

_B = hashing.BUCKET_SIZE
# the host tier's numpy dtype for a table's payload dtype: bfloat16 rows are
# kept as their bit patterns
_HOST_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
                torch.bfloat16: np.uint16}


def _to_host(rows: torch.Tensor) -> np.ndarray:
    """Payload rows as the tier holds them (bfloat16 as uint16 bits)."""
    if rows.dtype == torch.bfloat16:
        return rows.view(torch.int16).cpu().numpy().view(np.uint16)
    return rows.cpu().numpy()


def _from_host(payload: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Tier rows as a CPU tensor of the table's ``dtype``, bit for bit."""
    a = np.ascontiguousarray(payload)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


def _host_f32(payload: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Tier rows as float32 (exact for every payload dtype)."""
    return _from_host(payload, dtype).float().numpy()


class _NpIndex:
    """Vectorized uint64 → row-index map: numpy open-addressing hash table
    with linear probing, BATCH get/put/pop (no per-key Python — spilling or
    prefetching 10⁵ rows is a handful of array passes, round-1 weak spot #5).
    Single-threaded by design (tier moves are host-mediated between steps).
    """

    def __init__(self, cap: int = 2048):
        self._cap = cap
        self._keys = np.zeros((cap,), np.uint64)
        self._state = np.zeros((cap,), np.int8)   # 0 empty, 1 live, 2 tomb
        self._vals = np.zeros((cap,), np.int64)
        self.live = 0
        self._used = 0                            # live + tombstones

    @staticmethod
    def _mix(k: np.ndarray) -> np.ndarray:
        """splitmix64 finalizer (vectorized)."""
        k = np.asarray(k, np.uint64).copy()
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xFF51AFD7ED558CCD)
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xC4CEB9FE1A85EC53)
        k ^= k >> np.uint64(33)
        return k

    def _probe(self, keys: np.ndarray):
        """Batch find: ``(slot[N] live match or −1, free[N] first insertable
        slot on the probe path)``. Probing continues past tombstones and
        stops at live-match or empty."""
        n = len(keys)
        cap = self._cap
        h = (self._mix(keys) % np.uint64(cap)).astype(np.int64)
        slot = np.full(n, -1, np.int64)
        free = np.full(n, -1, np.int64)
        pending = np.ones(n, bool)
        for off in range(cap):
            if not pending.any():
                break
            idx = np.nonzero(pending)[0]
            pos = (h[idx] + off) % cap
            st = self._state[pos]
            hit = (st == 1) & (self._keys[pos] == keys[idx])
            slot[idx[hit]] = pos[hit]
            rec = (st != 1) & (free[idx] < 0)
            free[idx[rec]] = pos[rec]
            pending[idx[hit | (st == 0)]] = False
        return slot, free

    def _rehash(self, new_cap: int):
        old_keys = self._keys[self._state == 1]
        old_vals = self._vals[self._state == 1]
        self._cap = new_cap
        self._keys = np.zeros((new_cap,), np.uint64)
        self._state = np.zeros((new_cap,), np.int8)
        self._vals = np.zeros((new_cap,), np.int64)
        self.live = 0
        self._used = 0
        if len(old_keys):
            self.put(old_keys, old_vals)

    def get(self, keys: np.ndarray):
        """``(found bool[N], vals int64[N] — −1 where missing)``."""
        keys = np.asarray(keys, np.uint64)
        if not len(keys) or self.live == 0:
            return np.zeros(len(keys), bool), np.full(len(keys), -1, np.int64)
        slot, _ = self._probe(keys)
        found = slot >= 0
        vals = np.where(found, self._vals[np.where(found, slot, 0)], -1)
        return found, vals

    def put(self, keys: np.ndarray, vals: np.ndarray):
        """Batch upsert; ``keys`` must be unique within the batch."""
        keys = np.asarray(keys, np.uint64)
        vals = np.asarray(vals, np.int64)
        if (self._used + len(keys)) * 5 > self._cap * 3:   # load > 0.6
            cap = self._cap
            while (self.live + len(keys)) * 5 > cap * 3:
                cap *= 2
            self._rehash(cap)
        while len(keys):
            slot, free = self._probe(keys)
            found = slot >= 0
            self._vals[slot[found]] = vals[found]
            keys, vals, free = keys[~found], vals[~found], free[~found]
            if not len(keys):
                return
            # distinct keys can race for the same free slot: first wins,
            # losers re-probe (the slot is live next round, their probe
            # walks past it to the next free)
            _, first = np.unique(free, return_index=True)
            place = np.zeros(len(keys), bool)
            place[first] = True
            ps = free[place]
            self._used += int((self._state[ps] == 0).sum())
            self._keys[ps] = keys[place]
            self._state[ps] = 1
            self._vals[ps] = vals[place]
            self.live += int(place.sum())
            keys, vals = keys[~place], vals[~place]

    def pop(self, keys: np.ndarray):
        """Batch remove: ``(found bool[N], vals int64[N])``; hits become
        tombstones. Duplicate keys within the batch behave like repeated
        ``dict.pop``: only the FIRST occurrence is found (the rest would
        double-free arena rows and drive ``live`` negative)."""
        keys = np.asarray(keys, np.uint64)
        if not len(keys) or self.live == 0:
            return np.zeros(len(keys), bool), np.full(len(keys), -1, np.int64)
        slot, _ = self._probe(keys)
        found = slot >= 0
        if found.any():
            fidx = np.nonzero(found)[0]
            _, first = np.unique(slot[fidx], return_index=True)
            dup = np.ones(len(fidx), bool)
            dup[first] = False
            found[fidx[dup]] = False
        vals = np.where(found, self._vals[np.where(found, slot, 0)], -1)
        self._state[slot[found]] = 2
        self.live -= int(found.sum())
        return found, vals

    def values(self) -> np.ndarray:
        return self._vals[self._state == 1]


class HostStorageTier:
    """Growable host arena of spilled rows: ``keys u64[M]``,
    ``payload vdtype[M, W]`` (embedding + slot columns), ``meta uint32[M]``
    (internal packed word — freq | day13 | flags). Key lookup through the
    vectorized :class:`_NpIndex`; rows are recycled through a free list.
    All row ops are BATCH numpy operations — no per-key Python loops.

    Parity: MemStorageTable (storage_table.h:74-196) with the capacity /
    eviction hooks of StorageTableInterface; ``capacity == 0`` = unbounded.
    """

    def __init__(self, dim: int, payload_width: Optional[int] = None,
                 value_dtype: torch.dtype = torch.float32,
                 capacity: int = 0):
        """``value_dtype``: the table's payload dtype; ``put`` takes rows in
        the tier's format (``torch.bfloat16`` as uint16 bit patterns)."""
        self.dim = dim
        self.width = payload_width or dim
        self.torch_dtype = value_dtype
        self.value_dtype = np.dtype(_HOST_DTYPES[value_dtype])
        self.capacity = capacity
        self._index = _NpIndex()
        cap0 = 1024
        self._keys = np.zeros((cap0,), np.uint64)
        self._payload = np.zeros((cap0, self.width), self.value_dtype)
        self._meta = np.zeros((cap0,), np.uint32)
        self._free = list(range(cap0 - 1, -1, -1))

    # -- sizing ----------------------------------------------------------
    @property
    def size(self) -> int:
        return self._index.live

    @property
    def nbytes(self) -> int:
        return self._payload.nbytes + self._keys.nbytes + self._meta.nbytes

    def __contains__(self, id_u64: int) -> bool:
        found, _ = self._index.get(np.asarray([id_u64], np.uint64))
        return bool(found[0])

    def _grow_arena(self, need: int) -> None:
        cap = self._keys.shape[0]
        new_cap = cap
        while new_cap - self.size < need:
            new_cap *= 2
        if new_cap == cap:
            return
        self._keys = np.resize(self._keys, (new_cap,))
        pay = np.zeros((new_cap, self.width), self.value_dtype)
        pay[:cap] = self._payload
        self._payload = pay
        self._meta = np.resize(self._meta, (new_cap,))
        self._free.extend(range(new_cap - 1, cap - 1, -1))

    def ensure_width(self, width: int) -> None:
        """Widen payload columns (optimizer slots added after a spill)."""
        if width <= self.width:
            return
        pay = np.zeros((self._payload.shape[0], width), self.value_dtype)
        pay[:, :self.width] = self._payload
        self._payload = pay
        self.width = width

    # -- row ops ----------------------------------------------------------
    def put(self, ids_u64: np.ndarray, payload: np.ndarray,
            meta: np.ndarray) -> None:
        """Upsert rows (Put, storage_table.h:49). Raises if a bounded tier
        would overflow — size the budget with :attr:`capacity`."""
        ids_u64 = np.asarray(ids_u64, np.uint64).reshape(-1)
        n = ids_u64.shape[0]
        if n == 0:
            return
        payload = np.asarray(payload, self.value_dtype)
        meta = np.asarray(meta, np.uint32)
        # duplicate ids: keep the LAST occurrence (dict upsert semantics) —
        # otherwise each duplicate would claim its own arena row and leak
        # all but one. One reversed unique detects AND resolves them.
        _, last_rev = np.unique(ids_u64[::-1], return_index=True)
        if len(last_rev) != n:
            keep = np.sort(n - 1 - last_rev)
            ids_u64, payload, meta = ids_u64[keep], payload[keep], meta[keep]
            n = len(ids_u64)
        found, rows = self._index.get(ids_u64)
        fresh = int((~found).sum())
        if self.capacity and self.size + fresh > self.capacity:
            raise RuntimeError(
                f"HostStorageTier over capacity ({self.size}+{fresh} > "
                f"{self.capacity})")
        self._grow_arena(fresh)
        if fresh:
            new_rows = np.asarray(self._free[-fresh:], np.int64)
            del self._free[-fresh:]
            rows = rows.copy()
            rows[~found] = new_rows
            self._index.put(ids_u64[~found], new_rows)
            self._keys[new_rows] = ids_u64[~found]
        self._payload[rows] = payload
        self._meta[rows] = meta

    def lookup_rows(self, ids_u64: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Non-destructive Get: ``(found bool[N], payload [N, W], meta [N])``
        (zeros where missing)."""
        ids_u64 = np.asarray(ids_u64, np.uint64).reshape(-1)
        found, rows = self._index.get(ids_u64)
        safe = np.where(found, rows, 0)
        payload = np.where(found[:, None], self._payload[safe],
                           np.zeros((), self.value_dtype))
        meta = np.where(found, self._meta[safe], np.uint32(0))
        return found, payload, meta

    def take(self, ids_u64: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Destructive Get: like :meth:`lookup_rows` but removes the hits
        (tier-move semantics — a key lives in exactly one tier)."""
        ids_u64 = np.asarray(ids_u64, np.uint64).reshape(-1)
        found, rows = self._index.pop(ids_u64)
        safe = np.where(found, rows, 0)
        payload = np.where(found[:, None], self._payload[safe],
                           np.zeros((), self.value_dtype))
        meta = np.where(found, self._meta[safe], np.uint32(0))
        self._free.extend(rows[found].tolist())
        return found, payload, meta

    def delete(self, ids_u64: np.ndarray) -> int:
        """Evict keys outright (reference Evict, storage_table.h:53)."""
        ids_u64 = np.asarray(ids_u64, np.uint64).reshape(-1)
        found, rows = self._index.pop(ids_u64)
        self._free.extend(rows[found].tolist())
        return int(found.sum())

    # -- bulk views --------------------------------------------------------
    def live_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(keys u64[M], payload [M, W], meta uint32[M])`` of live rows."""
        rows = self._index.values()
        if not len(rows):
            return (np.zeros((0,), np.uint64),
                    np.zeros((0, self.width), self.value_dtype),
                    np.zeros((0,), np.uint32))
        return self._keys[rows], self._payload[rows], self._meta[rows]

    def clear_touch_bits(self, bit: np.uint32) -> None:
        rows = self._index.values()
        if len(rows):
            self._meta[rows] &= np.uint32(~int(bit) & 0xFFFFFFFF)

    def stats(self) -> dict:
        return {"size": self.size, "capacity": self.capacity,
                "width": self.width, "bytes": self.nbytes}


# ---------------------------------------------------------------------------
# tier moves (host-mediated, between steps)
# ---------------------------------------------------------------------------

def _drop_rows(table: kvt.KvTable, evict: torch.Tensor) -> kvt.KvTable:
    """Tombstone the rows of ``evict`` (bool[C]) in place, WITHOUT logging
    deletes: a tier move is not a logical deletion (the row still exists).
    Their meta and pad lanes become 0 and their payload rows zeros."""
    g = table.header.shape[0]
    v = table.header.view(g, 4, _B)
    repl = torch.tensor([hashing.TOMB_LO, hashing.TOMB_HI, 0, 0],
                        dtype=torch.int32, device=v.device).view(1, 4, 1)
    v.copy_(torch.where(evict.view(g, 1, _B), repl, v))
    table.payload.masked_fill_(evict[:, None], 0)
    return table


def _promote_rows(table: kvt.KvTable, q, payload_rows, meta) -> kvt.KvTable:
    """``insert_raw`` with placement verification: promoted rows were
    already taken OUT of the host tier, so a bucket-pair overflow would lose
    them. Grow (which disperses the colliding buckets) and insert again, at
    most 4 times; ``insert_raw`` writes payload and meta verbatim, so a
    repeat is harmless."""
    table = kvt.insert_raw(table, q, payload_rows, meta)
    fr = kvt.find(table, q)
    for _ in range(4):
        if not bool((~fr.found).any()):
            return table
        table = kvt.grow(table)
        table = kvt.insert_raw(table, q, payload_rows, meta)
        fr = kvt.find(table, q)
    missing = int((~fr.found).sum())
    raise RuntimeError(f"promotion could not place {missing} rows")


def _promote(table: kvt.KvTable, u64: np.ndarray, payload: np.ndarray,
             meta: np.ndarray) -> kvt.KvTable:
    """Put rows taken out of the host tier back on the card: grow first if
    they would pass the load factor, pad slot columns added since the rows
    were spilled, then :func:`_promote_rows`."""
    n = int(u64.size)
    if kvt.needs_grow(table, incoming=n):
        cap = table.capacity
        cur = int(kvt.size(table))
        while (cur + n) > kvt.GROW_LOAD_FACTOR * cap:
            cap *= 2
        table = kvt.grow(table, cap)
    w = table.payload.shape[1]
    if payload.shape[1] < w:   # slots added after the rows were spilled
        payload = np.concatenate(
            [payload, np.zeros((n, w - payload.shape[1]), payload.dtype)],
            axis=1)
    dev = table.device
    q = hashing.encode_ids_np_to_device(u64, dev)
    return _promote_rows(
        table, q, _from_host(payload[:, :w], table.payload.dtype).to(dev),
        torch.from_numpy(meta.astype(np.int64)).to(dev))


def _ids_u64(ids) -> np.ndarray:
    """uint64/int64 ids, or encoded ``int32[N, 2]`` keys (numpy or a
    tensor) → uint64[N]."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids)
    if ids.ndim >= 1 and ids.shape[-1] == 2 and ids.dtype == np.int32:
        return hashing.decode_ids_np(ids.reshape(-1, 2))
    return ids.astype(np.uint64).reshape(-1)


def spill(table: kvt.KvTable, tier: HostStorageTier, *,
          max_live: Optional[int] = None,
          min_freq: Optional[int] = None,
          older_than_days: Optional[int] = None,
          day: Optional[int] = None) -> Tuple[kvt.KvTable, int]:
    """Demote cold rows from the card to the host tier; returns ``(table,
    n_spilled)``, the table updated in place.

    Victims:
      * ``min_freq``: rows with visit frequency < min_freq,
      * ``older_than_days``: rows untouched for more than N days,
      * ``max_live``: if the live count still exceeds this budget, the
        (freq, recency)-coldest rows until it fits.
    Call between steps."""
    tier.ensure_width(table.payload.shape[1])
    keys = table.keys.cpu().numpy()
    meta = table.meta.cpu().numpy().astype(np.uint32)
    occ = ~(((keys[:, 0] == hashing.EMPTY_LO) & (keys[:, 1] == hashing.EMPTY_HI))
            | ((keys[:, 0] == hashing.TOMB_LO) & (keys[:, 1] == hashing.TOMB_HI)))
    freq = meta & np.uint32(packing.FREQ_MASK)
    row_day = (meta >> 16) & np.uint32(packing.DAY_MASK)
    victim = np.zeros_like(occ)
    if min_freq is not None:
        victim |= occ & (freq < min_freq)
    if older_than_days is not None:
        now = packing.current_day() if day is None else int(day)
        age = (np.int64(now & packing.DAY_MASK) - row_day.astype(np.int64)) \
            & packing.DAY_MASK
        victim |= occ & (age > older_than_days)
    if max_live is not None:
        live = int(occ.sum()) - int(victim.sum())
        over = live - max_live
        if over > 0:
            cand = occ & ~victim
            # coldness = (freq, day): evict lowest-frequency, oldest first
            priority = (freq.astype(np.int64) << 16) | row_day.astype(np.int64)
            priority = np.where(cand, priority, np.int64(1) << 62)
            order = np.argsort(priority, kind="stable")[:over]
            victim[order] = True
    idx = np.nonzero(victim)[0]
    if idx.size == 0:
        return table, 0
    dev = table.device
    rows = rowops.gather_rows(
        table.payload, torch.from_numpy(idx.astype(np.int32)).to(dev))
    tier.put(hashing.decode_ids_np(keys[idx]), _to_host(rows), meta[idx])
    return _drop_rows(table, torch.from_numpy(victim).to(dev)), int(idx.size)


def prefetch(table: kvt.KvTable, tier: HostStorageTier,
             ids) -> Tuple[kvt.KvTable, int]:
    """Promote the given ids' rows from the host tier to the card (those
    that were spilled), so the next step finds them with their values,
    optimizer slots and frequency. ``ids``: uint64/int64 ids, or encoded
    ``int32[N, 2]`` keys. Returns ``(table, n_promoted)``: the same table,
    or a NEW one if it had to grow."""
    u64 = np.unique(_ids_u64(ids))
    if tier.size == 0 or u64.size == 0:
        return table, 0
    found, payload, meta = tier.take(u64)
    n = int(found.sum())
    if n == 0:
        return table, 0
    sel = np.nonzero(found)[0]
    return _promote(table, u64[sel], payload[sel], meta[sel]), n


# ---------------------------------------------------------------------------
# tier-aware checkpoint (merged logical tensors — format stays tier-agnostic)
# ---------------------------------------------------------------------------

def export_hybrid_arrays(table: kvt.KvTable, tier: HostStorageTier, *,
                         enable_cutoff: bool = False,
                         cutoff_value: float = 1e-20,
                         delta: bool = False,
                         deltalist: str = "train") -> Dict[str, np.ndarray]:
    """Union of both tiers in ``export_arrays``' format (``keys``,
    ``values``, ``init_table``, ``blacklist``, ``freq_*``, ``meta``), plus
    ``slot-<name>`` rows when the table has optimizer slots: the card's rows
    first, then the tier's. Delta mode includes touched rows from EITHER
    tier and clears both tiers' touch bits for ``deltalist``."""
    ex = kvt.export_arrays(table, enable_cutoff=enable_cutoff,
                           cutoff_value=cutoff_value, delta=delta,
                           clear_deltalist=delta)
    dev_table = ex.get("table", table)
    dim = table.config.dim

    # device-tier slot rows for the exported keys
    slots: Dict[str, np.ndarray] = {}
    slot_cols = table.config.slot_columns()
    if slot_cols and ex["keys"].size:
        q = hashing.encode_ids_np_to_device(ex["keys"], table.device)
        fr = kvt.find(table, q)
        prow = rowops.gather_rows(
            table.payload, torch.where(fr.found, fr.slot, 0)).float()
        prow = prow.cpu().numpy()
        for sname, (s, wid) in slot_cols.items():
            slots[sname] = prow[:, s:s + wid]

    t_keys, t_payload, t_meta = tier.live_rows()
    if delta:
        bit = packing.FLAG_TOUCH_TRAIN if deltalist == "train" \
            else packing.FLAG_TOUCH_PRED
        sel = (t_meta & np.uint32(bit)) != 0
        t_keys, t_payload, t_meta = t_keys[sel], t_payload[sel], t_meta[sel]
        tier.clear_touch_bits(np.uint32(bit))
    t_payload = _host_f32(t_payload, tier.torch_dtype)
    t_black = (t_meta & np.uint32(packing.FLAG_BLACKLIST)) != 0
    if enable_cutoff and t_keys.size:
        keep = np.abs(t_payload[:, :dim]).max(axis=1) >= cutoff_value
        sel = keep | t_black
        t_keys, t_payload, t_meta, t_black = (t_keys[sel], t_payload[sel],
                                              t_meta[sel], t_black[sel])

    ref_meta_t = ((t_meta & np.uint32(packing.FREQ_MASK))
                  | (((t_meta >> 16) & np.uint32(packing.DAY_MASK)) << 16))
    out = dict(ex)
    out["table"] = dev_table
    out["keys"] = np.concatenate([ex["keys"], t_keys])
    out["values"] = np.concatenate(
        [ex["values"], t_payload[:, :dim].astype(np.float32)])
    out["blacklist"] = np.concatenate([ex["blacklist"], t_keys[t_black]])
    out["freq_keys"] = out["keys"]
    out["freq_values"] = np.concatenate(
        [ex["freq_values"],
         (t_meta & np.uint32(packing.FREQ_MASK)).astype(np.uint16)])
    out["meta"] = np.concatenate([ex["meta"], ref_meta_t])
    for sname, (s, wid) in slot_cols.items():
        dev = slots.get(sname, np.zeros((0, wid), np.float32))
        if t_payload.shape[1] >= s + wid:
            tr = t_payload[:, s:s + wid]
        else:
            tr = np.zeros((t_keys.shape[0], wid), dev.dtype)
        out[f"slot-{sname}"] = np.concatenate([dev.astype(np.float32),
                                               tr.astype(np.float32)])
    return out


def restore_hybrid_split(template: kvt.KvTable, tier: HostStorageTier,
                         data: Dict[str, np.ndarray], *,
                         max_live: Optional[int] = None,
                         slots: Optional[Dict[str, np.ndarray]] = None
                         ) -> kvt.KvTable:
    """Restore exported arrays into a (card, host tier) pair: the
    ``max_live`` highest-frequency rows go to a NEW device table (through
    ``import_arrays(template, ..., clear=True)``), the rest straight into
    the host tier without passing through the card. ``slots``: optional
    ``name -> [n, k*dim]`` rows aligned with ``data['keys']``."""
    keys = np.asarray(data["keys"], np.uint64)
    values = np.asarray(data["values"], np.float32)
    n = keys.shape[0]
    meta_ref = np.asarray(data.get("meta", np.zeros((n,), np.uint32)),
                          np.uint32)
    freq = meta_ref & np.uint32(packing.FREQ_MASK)
    days = meta_ref >> 16
    black = np.zeros((n,), bool)
    bl = np.asarray(data.get("blacklist", np.zeros((0,), np.uint64)),
                    np.uint64)
    if bl.size:
        black = np.isin(keys, bl)
    hot = np.ones((n,), bool)
    if max_live is not None and n > max_live:
        order = np.argsort(freq.astype(np.int64), kind="stable")
        hot[order[:n - max_live]] = False

    hot_data = {
        "keys": keys[hot], "values": values[hot], "meta": meta_ref[hot],
        "blacklist": keys[hot & black],
        "init_table": data.get("init_table",
                               template.init_pool.float().cpu().numpy()),
    }
    table = kvt.import_arrays(template, hot_data, clear=True)
    if slots:
        q = hashing.encode_ids_np_to_device(keys[hot], table.device)
        fr = kvt.find(table, q)
        idx = torch.where(fr.found, fr.slot, -1)
        for sname, rows in slots.items():
            rows = np.asarray(rows)
            k = rows.shape[1] // template.dim
            if sname not in table.config.slot_columns():
                table = kvt.ensure_slots(table, {sname: k})
            table = kvt.set_slot_rows(table, sname, idx,
                                      torch.from_numpy(rows[hot]))

    cold = ~hot
    if cold.any():
        tier.ensure_width(table.payload.shape[1])
        w = tier.width
        payload = np.zeros((int(cold.sum()), w), np.float32)
        payload[:, :template.dim] = values[cold]
        if slots:
            for sname, rows in slots.items():
                if sname in table.config.slot_columns():
                    s, wid = table.config.slot_columns()[sname]
                    payload[:, s:s + wid] = np.asarray(rows)[cold]
        flags = np.where(black[cold], np.uint32(packing.FLAG_BLACKLIST),
                         np.uint32(0))
        meta_int = (((days[cold] & np.uint32(packing.DAY_MASK)) << 16)
                    | (freq[cold] & np.uint32(packing.FREQ_MASK)) | flags)
        tier.put(keys[cold],
                 _to_host(torch.from_numpy(payload).to(tier.torch_dtype)),
                 meta_int.astype(np.uint32))
    return table


class AsyncPrefetcher:
    """Overlap the host tier's row extraction with the running device step.

    Protocol: when step ``t`` is launched, ``submit(ids_of_step_t_plus_1)``
    starts a worker thread that dedups the ids and ``take``s their spilled
    rows out of the tier (host numpy only). Then ``table, n =
    apply(table)`` between steps joins it and promotes the staged rows to
    the card on the calling thread. Staged rows live outside BOTH tiers
    while in flight, so ``apply`` (or ``drain``, which puts them back) must
    run before a hybrid export, and nothing else may use the tier until
    then: the tier is not safe for two threads at once.
    """

    def __init__(self, tier: HostStorageTier):
        self.tier = tier
        self._thread = None
        self._staged = None

    def submit(self, ids) -> None:
        if self._thread is not None or self._staged is not None:
            raise RuntimeError("previous prefetch not applied/drained")
        u64 = _ids_u64(ids)

        def _work():
            u = np.unique(u64)
            if self.tier.size == 0 or u.size == 0:
                self._staged = (np.zeros((0,), np.uint64), None, None)
                return
            found, payload, meta = self.tier.take(u)
            sel = np.nonzero(found)[0]
            self._staged = (u[sel], payload[sel], meta[sel])

        self._thread = threading.Thread(target=_work, name="kv-prefetch",
                                        daemon=True)
        self._thread.start()

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def apply(self, table: kvt.KvTable) -> Tuple[kvt.KvTable, int]:
        """Promote the staged rows into the device table (between steps)."""
        self._join()
        if self._staged is None:
            return table, 0
        u64, payload, meta = self._staged
        self._staged = None
        n = int(u64.size)
        if n == 0:
            return table, 0
        return _promote(table, u64, payload, meta), n

    def drain(self) -> int:
        """Abandon the staged prefetch: return its rows to the host tier
        (e.g. before a checkpoint export when apply() won't run)."""
        self._join()
        if self._staged is None:
            return 0
        u64, payload, meta = self._staged
        self._staged = None
        if u64.size:
            self.tier.put(u64, payload, meta)
        return int(u64.size)


class HybridTable:
    """Two-tier wrapper: the device :class:`KvTable` and its host tier,
    with the between-step protocol ``prefetch(next_ids)`` → step on
    ``.table`` → ``maybe_spill()``. ``.table`` may be replaced by a grown
    table after a prefetch: read it anew after each call."""

    def __init__(self, table: kvt.KvTable, *,
                 max_live: Optional[int] = None,
                 min_freq: Optional[int] = None,
                 older_than_days: Optional[int] = None,
                 tier_capacity: int = 0):
        self.table = table
        self.tier = HostStorageTier(
            table.dim, table.payload.shape[1], table.config.value_dtype,
            capacity=tier_capacity)
        self.max_live = max_live
        self.min_freq = min_freq
        self.older_than_days = older_than_days
        self._prefetcher = AsyncPrefetcher(self.tier)

    @property
    def logical_size(self) -> int:
        return int(kvt.size(self.table)) + self.tier.size

    def prefetch(self, ids) -> int:
        self.table, n = prefetch(self.table, self.tier, ids)
        return n

    # -- overlapped prefetch (AsyncPrefetcher protocol) --------------------
    def prefetch_async(self, next_ids) -> None:
        """Start extracting ``next_ids``'s spilled rows on a worker thread
        while the current step runs; pair with :meth:`apply_prefetch`."""
        self._prefetcher.submit(next_ids)

    def apply_prefetch(self) -> int:
        self.table, n = self._prefetcher.apply(self.table)
        return n

    def maybe_spill(self, day: Optional[int] = None) -> int:
        self.table, n = spill(self.table, self.tier, max_live=self.max_live,
                              min_freq=self.min_freq,
                              older_than_days=self.older_than_days, day=day)
        return n

    def stats(self) -> dict:
        dev = kvt.stats(self.table)
        return {"device": dev, "host_tier": self.tier.stats(),
                "logical_size": dev["size"] + self.tier.size}
