"""KvTable — device-resident key→row embedding table.

Counterpart of ``tfplus_tpu/kv/table.py``: a slotted open-addressing table
with two-choice 16-slot buckets, a bucket-planar ``int32`` header (one
64-lane row per bucket: 16 key_lo lanes, 16 key_hi, 16 packed meta words,
16 pad) and one payload array ``[C, D + Σk·D]`` (embedding columns followed
by optimizer slot segments). Placement is a pure function of (keys, their
order, capacity) and matches the JAX package bit for bit: after the same
operations both hold identical header and payload arrays.

PyTorch idiom, not JAX's: the functions here update ``header`` and
``payload`` IN PLACE and still return the table, so that call sites read like
the JAX ones. A table handed to a mutating call is the table that comes back.
Payload rows move through :mod:`tfplus_tpu_torch.ops.rowops`, whose CUDA
kernels run for tables on the card.

Growth (:func:`grow`, :func:`grow_to_fit`, :func:`compact`) and a clearing
import (:func:`import_arrays` with ``clear=True``) return a NEW table: the
header and payload are reallocated at the new capacity, and the old table's
tensors must not be used for the new one.

Device syncs. On the card, :func:`find` is one launch of
:func:`tfplus_tpu_torch.ops.probe.probe` and reads nothing back; on the
CPU it runs :func:`_find_plain`, the kernel's plain version. On the card,
the claim insert of ``lookup_or_insert`` and ``_claim_insert`` (the JAX
package's ``lax.while_loop``) is one launch of
:func:`tfplus_tpu_torch.ops.claim.claim_insert`: every round and the counts
run on the device, the misses' initial rows are one ungated row scatter,
and nothing is read back. On the CPU the rounds are Python control flow
(:func:`_claim_rounds`, the kernel's plain version), so they read values
back: the miss count before the rounds (the miss gate), whether any key is
still unplaced before each round after the first, whether any miss was
placed (the initial-row gate), and the unplaced count once more only when
every round ran. On both, the doubling's spill gate reads one boolean and
growth reads the live count before and after each rebuild. The counts feed
:func:`~tfplus_tpu_torch.utils.profiling.counters` (``misses``,
``claim_rounds``, ``inserted``, ``unplaced``, and the probe's ``probed``
and ``found``), from the host on the CPU and from the device counter
buffer on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import hashing
from ..ops import claim, probe, rowops
from ..utils import device as _dev
from ..utils import packing, profiling

FLAG_BLACKLIST = packing.FLAG_BLACKLIST
FLAG_TOUCH_TRAIN = packing.FLAG_TOUCH_TRAIN
FLAG_TOUCH_PRED = packing.FLAG_TOUCH_PRED
FLAG_TOUCH_BOTH = packing.FLAG_TOUCH_BOTH

DEFAULT_MAX_PROBES = 32
DEFAULT_INIT_POOL_ROWS = 10000
GROW_LOAD_FACTOR = 0.7
DELETED_LOG_CAPACITY = 4096

_B = hashing.BUCKET_SIZE


@dataclasses.dataclass(frozen=True)
class KvConfig:
    """Static per-table options (see the JAX package's ``KvConfig``)."""
    dim: int
    enter_threshold: int = 0
    max_probes: int = DEFAULT_MAX_PROBES
    value_dtype: Any = torch.float32
    name: str = "kv_table"
    slot_layout: tuple = ()           # ((name, k), ...): k*dim columns each
    #: keep deletions visible to BOTH delta streams (train + pred) until each
    #: has exported them; off: a delta export clears the deletion log
    support_prediction_delta: bool = False

    def __post_init__(self):
        if not isinstance(self.value_dtype, torch.dtype):
            raise TypeError(f"value_dtype must be a torch.dtype, got "
                            f"{self.value_dtype!r}")
        # probing covers exactly the two candidate buckets that find() scans
        limit = 2 * _B
        if not (1 <= self.max_probes <= limit):
            raise ValueError(
                f"max_probes must be in [1, {limit}] (two-choice bucketized "
                f"probing scans 2x{_B} slots), got {self.max_probes}")

    @property
    def payload_width(self) -> int:
        return self.dim * (1 + sum(k for _, k in self.slot_layout))

    def slot_columns(self) -> Dict[str, tuple]:
        """name -> (start_col, num_cols) within the payload."""
        out, col = {}, self.dim
        for name, k in self.slot_layout:
            out[name] = (col, k * self.dim)
            col += k * self.dim
        return out


def _meta_i32(m: torch.Tensor) -> torch.Tensor:
    """Packed meta (int64 holding uint32) → bit-identical int32 lane word."""
    return (((m + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _meta_u32(m: torch.Tensor) -> torch.Tensor:
    """int32 lane word → int64 holding its uint32 value."""
    return m.to(torch.int64) & 0xFFFFFFFF


# planar header flat-position helpers: slot idx -> positions of its lanes in
# header.view(-1). Buckets are 64-lane rows (16 slots x 4 fields).
def _hpos_lo(idx):
    return (idx >> 4) * 64 + (idx & 15)


def _hpos_hi(idx):
    return (idx >> 4) * 64 + 16 + (idx & 15)


def _hpos_meta(idx):
    return (idx >> 4) * 64 + 32 + (idx & 15)


def _set_meta_at(header: torch.Tensor, idx: torch.Tensor,
                 meta: torch.Tensor) -> torch.Tensor:
    """Write packed meta words at slot indices ``idx``, in place. Entries
    equal to the capacity are dropped (the JAX ``mode="drop"`` sentinel:
    ``_hpos_meta(capacity)`` lies past the header)."""
    keep = idx < header.shape[0] * _B
    flat = header.view(-1)
    flat[_hpos_meta(idx[keep].long())] = _meta_i32(meta[keep])
    return header


def _set_all_meta(header: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Replace the whole meta plane (``meta`` holds C uint32 values), in
    place."""
    g = header.shape[0]
    header.view(g, 4, _B)[:, 2, :] = _meta_i32(meta).view(g, _B)
    return header


def _set_all_pad(header: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Replace the whole pad plane (lanes 48-63; ``words`` is int32[C]), in
    place. The pad lanes are free 32-bit storage per slot that comes with
    the probe's bucket read: the int8 serving table keeps its per-row
    dequantization scale there (``kv/quant.py``)."""
    g = header.shape[0]
    header.view(g, 4, _B)[:, 3, :] = words.view(g, _B)
    return header


def _get_all_pad(header: torch.Tensor) -> torch.Tensor:
    """The whole pad plane as int32[C] (a copy)."""
    return header.view(header.shape[0], 4, _B)[:, 3, :].reshape(-1)


def _empty_header(num_buckets: int, device) -> torch.Tensor:
    """All-empty planar header: key lanes = EMPTY sentinel, meta/pad = 0."""
    header = torch.zeros((num_buckets, 64), dtype=torch.int32, device=device)
    header[:, :2 * _B] = hashing.EMPTY_LO
    return header


@dataclasses.dataclass
class KvTable:
    header: torch.Tensor               # int32[C // 16, 64], bucket-planar
    payload: torch.Tensor              # vdtype[C, D + Σk·D]
    init_pool: torch.Tensor            # vdtype[P, D]
    deleted_keys: torch.Tensor         # int32[DELBUF, 2]
    deleted_count: torch.Tensor        # int32 scalar
    deleted_overflow: torch.Tensor     # bool scalar
    deleted_seen_train: torch.Tensor   # int32 scalar
    deleted_seen_pred: torch.Tensor    # int32 scalar
    config: KvConfig

    @property
    def capacity(self) -> int:
        return self.header.shape[0] * _B

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def device(self) -> torch.device:
        return self.header.device

    # keys/meta views of the planar header (materialise a [C, ...] copy)
    @property
    def keys(self) -> torch.Tensor:
        v = self.header.view(-1, 4, _B)
        return torch.stack([v[:, 0, :].reshape(-1), v[:, 1, :].reshape(-1)],
                           dim=-1)

    @property
    def meta(self) -> torch.Tensor:
        """Packed meta words, int64 holding uint32 values."""
        return _meta_u32(self.header.view(-1, 4, _B)[:, 2, :].reshape(-1))

    # column views of the payload (no copy)
    @property
    def values(self) -> torch.Tensor:
        return self.payload[..., :self.config.dim]

    @property
    def slots(self) -> Dict[str, torch.Tensor]:
        return {name: self.payload[..., s:s + w]
                for name, (s, w) in self.config.slot_columns().items()}


class FindResult(NamedTuple):
    slot: torch.Tensor         # int32[N]; -1 if not found
    found: torch.Tensor        # bool[N]
    insert_slot: torch.Tensor  # int32[N]; first free candidate (-1 if none)
    meta: torch.Tensor         # int64[N] packed meta of the found slot (0 if none)
    # int32[N] pad-lane word of the found slot (0 if none); only with
    # find(want_pad=True)
    pad: Optional[torch.Tensor] = None


class LookupResult(NamedTuple):
    rows: torch.Tensor      # vdtype[N, D] (zeros for invalid / blacklisted)
    slot: torch.Tensor      # int32[N]; -1 invalid/overflow
    table: "KvTable"
    overflow: torch.Tensor  # bool scalar: some id could not be placed
    payload_rows: Optional[torch.Tensor] = None   # raw gathered rows [N, W]
    meta_rows: Optional[torch.Tensor] = None      # meta after this lookup


def create(dim: int,
           capacity: int = 1 << 14,
           *,
           initializer=None,
           init_pool_rows: int = DEFAULT_INIT_POOL_ROWS,
           enter_threshold: int = 0,
           max_probes: int = DEFAULT_MAX_PROBES,
           value_dtype=torch.float32,
           name: str = "kv_table",
           support_prediction_delta: bool = False,
           seed: int = 0,
           device="cuda") -> KvTable:
    """Create an empty table on ``device``.

    ``initializer``: callable ``(generator, shape) -> tensor`` for the init
    pool, or a concrete ``[P, dim]`` array. Defaults to a normal truncated at
    ±2 scaled by 0.05, drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (so the pool is the same on every device).
    """
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    if capacity < 2 * _B:
        raise ValueError(f"capacity must be >= {2 * _B}")
    dev = _dev.resolve(device)
    cfg = KvConfig(dim=dim, enter_threshold=enter_threshold,
                   max_probes=max_probes, value_dtype=value_dtype, name=name,
                   support_prediction_delta=support_prediction_delta)
    gen = torch.Generator().manual_seed(seed)
    if initializer is None:
        pool = torch.empty((init_pool_rows, dim))
        torch.nn.init.trunc_normal_(pool, 0.0, 1.0, -2.0, 2.0, generator=gen)
        pool = pool * 0.05
    elif callable(initializer):
        pool = initializer(gen, (init_pool_rows, dim))
    else:
        pool = torch.as_tensor(initializer)
        if pool.ndim != 2 or pool.shape[1] != dim:
            raise ValueError(f"init pool must be [P, {dim}], got "
                             f"{tuple(pool.shape)}")
    return KvTable(
        header=_empty_header(capacity // _B, dev),
        payload=torch.zeros((capacity, dim), dtype=value_dtype, device=dev),
        init_pool=pool.to(device=dev, dtype=value_dtype),
        config=cfg, **_empty_deletion_log(dev))


def _empty_deletion_log(device) -> Dict[str, torch.Tensor]:
    """A new table's deletion-log fields: no deleted keys, no overflow, both
    streams' watermarks at 0."""
    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return dict(
        deleted_keys=torch.full((DELETED_LOG_CAPACITY, 2), hashing.EMPTY_LO,
                                dtype=torch.int32, device=device),
        deleted_count=scalar(torch.int32),
        deleted_overflow=scalar(torch.bool),
        deleted_seen_train=scalar(torch.int32),
        deleted_seen_pred=scalar(torch.int32))


# ---------------------------------------------------------------------------
# probing
# ---------------------------------------------------------------------------

def _bucket_scan(g: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
                 want_pad: bool = False):
    """Scan gathered planar buckets ``g`` [N, 64] for a key match and the
    first free lane. Returns ``(mj, fj, meta, pad)``: first matching lane,
    first free lane (both == 16 when none), the matched slot's packed meta
    (0 when none; at most one lane matches, so a masked sum extracts it)
    and, only with ``want_pad``, its pad-lane word the same way."""
    lo = g[:, :_B]
    hi = g[:, _B:2 * _B]
    match = (lo == q[:, :1]) & (hi == q[:, 1:2]) & valid[:, None]
    free = ((lo == hashing.EMPTY_LO) | (lo == hashing.TOMB_LO)) \
        & (hi == hashing.EMPTY_HI)
    j = torch.arange(_B, device=g.device)[None, :]
    mj = torch.where(match, j, _B).amin(dim=1)
    fj = torch.where(free, j, _B).amin(dim=1)
    meta = torch.where(match, _meta_u32(g[:, 2 * _B:3 * _B]), 0).sum(dim=1)
    pad = None
    if want_pad:
        pad = torch.where(match, g[:, 3 * _B:], 0).sum(dim=1).to(torch.int32)
    return mj, fj, meta, pad


def _valid_keys(q: torch.Tensor, valid: Optional[torch.Tensor]):
    ok = ~hashing.is_reserved_id(q)
    return ok if valid is None else valid & ok


def find(table: KvTable, q: torch.Tensor,
         valid: Optional[torch.Tensor] = None, *,
         want_pad: bool = False) -> FindResult:
    """Probe both candidate buckets of each query key (int32[N, 2]).
    ``want_pad`` also returns the found slots' pad-lane words, read from
    the same bucket rows. Reads only ``table.header``, so an int8
    ``QuantKvTable`` probes through it too. On the card one launch of
    :func:`tfplus_tpu_torch.ops.probe.probe`, on the CPU
    :func:`_find_plain`; both count ``probed`` and ``found``."""
    with profiling.annotate("tfp::probe"):
        if table.header.is_cuda:
            return FindResult(*probe.probe(table.header, q, valid, want_pad))
        return _find_plain(table, q, valid, want_pad=want_pad)


def _find_plain(table: KvTable, q: torch.Tensor,
                valid: Optional[torch.Tensor] = None, *,
                want_pad: bool = False) -> FindResult:
    """:func:`find` as eager tensor ops: the CPU path, and the plain version
    of the probe kernel (``ops/csrc/probe.cu``), which gives the same
    result bit for bit. Counts ``probed`` and ``found`` with one host read
    each."""
    valid = _valid_keys(q, valid)
    b1, b2 = hashing.bucket_choices(q, table.capacity)
    mj1, fj1, meta1, pad1 = _bucket_scan(table.header[b1], q, valid,
                                         want_pad)
    mj2, fj2, meta2, pad2 = _bucket_scan(table.header[b2], q, valid,
                                         want_pad)
    f1 = mj1 < _B
    f2 = mj2 < _B
    found = f1 | f2
    slot = torch.where(f1, b1 * _B + mj1,
                       torch.where(f2, b2 * _B + mj2, -1))
    meta = torch.where(f1, meta1, meta2)
    pad = torch.where(f1, pad1, pad2) if want_pad else None
    hf1 = fj1 < _B
    has_free = (hf1 | (fj2 < _B)) & valid
    ins = torch.where(has_free,
                      torch.where(hf1, b1 * _B + fj1, b2 * _B + fj2), -1)
    profiling.count(probed=int(valid.sum()), found=int(found.sum()))
    return FindResult(slot=slot.to(torch.int32), found=found,
                      insert_slot=ins.to(torch.int32), meta=meta, pad=pad)


def _miss_gate(need: torch.Tensor) -> int:
    """How many entries of ``need`` are set (counted as ``misses``): one
    read, which lets a batch without misses (the steady state) skip all
    insert work."""
    misses = int(need.sum())
    profiling.count(misses=misses)
    return misses


def _claim_insert(header: torch.Tensor, q: torch.Tensor, need: torch.Tensor,
                  max_probes: int, *, misses: Optional[int] = None,
                  table: Optional[KvTable] = None):
    """Deterministic parallel insert of **unique** keys, IN PLACE on
    ``header``: on the card one claim-insert kernel launch, on the CPU
    :func:`_claim_rounds` behind the miss gate (``misses``: its count where
    the caller already read it). With ``table`` (whose header this is),
    also writes the placed keys' initial payload rows (init-pool embedding
    columns, zero slot columns) with the row scatter: on the card the
    kernel computes them and the scatter is not gated, on the CPU
    :func:`_init_rows_for` computes them and the scatter runs only where a
    key was placed. Returns ``(header, placed int32[N] (-1 = overflow))``."""
    if header.is_cuda:
        if table is None:
            return header, claim.claim_insert(header, q, need, max_probes)
        rows = table.payload.new_empty((q.shape[0], table.payload.shape[1]))
        placed = claim.claim_insert(header, q, need, max_probes,
                                    pool=table.init_pool, rows=rows)
        rowops.scatter_rows(table.payload, placed, rows)
        return header, placed
    if misses is None:
        misses = _miss_gate(need)
    placed = (_claim_rounds(header, q, need, misses, max_probes) if misses
              else torch.full((q.shape[0],), -1, dtype=torch.int32,
                              device=header.device))
    if table is not None:
        newly = need & (placed >= 0)
        if bool(newly.any()):
            init = _init_rows_for(table, q)
            w, dim = table.payload.shape[1], table.config.dim
            if w != dim:
                init = torch.cat([init, init.new_zeros((q.shape[0], w - dim))],
                                 dim=1)
            rowops.scatter_rows(table.payload, torch.where(newly, placed, -1),
                                init)
    return header, placed


def _claim_rounds(header: torch.Tensor, q: torch.Tensor, need: torch.Tensor,
                  misses: int, max_probes: int) -> torch.Tensor:
    """The claim rounds of :func:`_claim_insert` for the ``misses`` keys of
    ``need``, IN PLACE on ``header``; returns ``placed`` int32[N] (-1 =
    overflow). The CPU path, and the plain version of the claim-insert
    kernel (``ops/csrc/claim.cu``), which leaves the same header bit for
    bit.

    ``max_probes`` rounds; in round *j* every still-unplaced key attempts its
    *j*-th candidate slot (lanes of bucket b1, then of b2); collisions on a
    free slot go to the lowest query index via a scatter-min claim array.
    Claimed slots keep meta 0 (the free-slot invariant); callers stamp real
    meta afterwards. Each round is a ``tfp::claim_round`` span; the rounds,
    the placed and the unplaced keys are counted (the unplaced with one
    more read, only when every round ran).
    """
    n = q.shape[0]
    dev = header.device
    cap = header.shape[0] * _B
    placed = torch.full((n,), -1, dtype=torch.int64, device=dev)
    max_probes = min(max_probes, 2 * _B)
    flat = header.view(-1)
    iota = torch.arange(n, device=dev)
    b1, b2 = hashing.bucket_choices(q, cap)
    q_lo, q_hi = q[:, 0], q[:, 1]

    def read_key(pos):
        return torch.stack([flat[_hpos_lo(pos)], flat[_hpos_hi(pos)]], dim=-1)

    rounds, unplaced = 0, None
    for j in range(max_probes):
        active = need & (placed < 0)
        # early exit: almost always 1-2 rounds resolve all claims
        if j and not bool(active.any()):
            unplaced = 0
            break
        rounds += 1
        with profiling.annotate("tfp::claim_round"):
            pos = b1 * _B + j if j < _B else b2 * _B + (j - _B)
            attempt = active & hashing.is_free(read_key(pos))
            claim = torch.full((cap,), n, dtype=torch.int64, device=dev)
            claim.scatter_reduce_(0, pos, torch.where(attempt, iota, n),
                                  "amin")
            won = attempt & (claim[pos] == iota)
            wpos = pos[won]
            flat[_hpos_lo(wpos)] = q_lo[won]
            flat[_hpos_hi(wpos)] = q_hi[won]
            # duplicate safety: a claim loser whose slot now holds ITS key
            # was raced by its own twin — adopt that slot (read after the
            # writes)
            dup_hit = active & hashing.keys_equal(read_key(pos), q)
            placed = torch.where(won | dup_hit, pos, placed)
    if unplaced is None:
        unplaced = int((need & (placed < 0)).sum())
    profiling.count(claim_rounds=rounds, inserted=misses - unplaced,
                    unplaced=unplaced)
    return placed.to(torch.int32)


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def _gather_payload(table: KvTable, slot: torch.Tensor,
                    ok: torch.Tensor) -> torch.Tensor:
    """Gather FULL payload rows [N, W] through the row-gather kernel."""
    return rowops.gather_rows(table.payload,
                              torch.where(ok, slot, -1).to(torch.int32))


def _rows_view(table: KvTable, payload_rows: torch.Tensor, ok: torch.Tensor,
               meta_rows: torch.Tensor) -> torch.Tensor:
    """Embedding columns of gathered payload rows, with blacklisted /
    invalid rows read as zeros."""
    rows = payload_rows[:, :table.config.dim]
    ok = ok & ((meta_rows & FLAG_BLACKLIST) == 0)
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def _gather_rows(table: KvTable, slot: torch.Tensor, ok: torch.Tensor,
                 meta_rows: torch.Tensor) -> torch.Tensor:
    """Embedding columns of the rows at ``slot``; ``meta_rows`` is the
    probe's meta (it came with the bucket read)."""
    with profiling.annotate("tfp::gather"):
        return _rows_view(table, _gather_payload(table, slot, ok), ok,
                          meta_rows)


def _init_rows_for(table: KvTable, q: torch.Tensor) -> torch.Tensor:
    pool = table.init_pool
    r1, r2 = hashing.init_row_indices(q, pool.shape[0])
    return (pool[r1] + pool[r2]) * 0.5


def lookup_or_insert(table: KvTable,
                     q: torch.Tensor,
                     counts: Optional[torch.Tensor] = None,
                     *,
                     valid: Optional[torch.Tensor] = None,
                     day=0,
                     mark_delta: bool = True,
                     defer_meta: bool = False) -> LookupResult:
    """Training-path gather: find each key, insert misses with init-pool rows
    (header and payload updated in place). Dedup ``q`` first for exact
    frequency accounting; placement itself is duplicate-safe. ``counts`` is
    the per-key multiplicity.

    ``mark_delta=False`` sets no delta-touch bits on rows that already
    existed (new rows are always marked for both streams).

    ``defer_meta=True`` (without a frequency filter) leaves the meta update
    to the optimizer's meta write over the same slots: the freq/day/touch
    words come back in ``meta_rows``.
    """
    n = q.shape[0]
    valid = _valid_keys(q, valid)
    if counts is None:
        counts = torch.ones((n,), dtype=torch.int32, device=q.device)

    fr = find(table, q, valid)
    need = valid & ~fr.found
    header, payload = table.header, table.payload
    # on the card the insert reads nothing back and opens its span on every
    # batch; on the CPU the miss gate skips a batch without misses (the
    # steady state), span included
    misses = None if header.is_cuda else _miss_gate(need)
    with (profiling.annotate("tfp::insert") if misses is None or misses
          else contextlib.nullcontext()):
        # the misses' slots and initial rows
        _, placed_new = _claim_insert(header, q, need,
                                      table.config.max_probes,
                                      misses=misses, table=table)
        placed = torch.where(fr.found, fr.slot, placed_new)
        ok = valid & (placed >= 0)
        overflow = (need & (placed_new < 0)).any()
        newly = need & (placed_new >= 0)

        # metadata: freq count, day stamp, delta-touch bits, preserved
        # blacklist bit. The old meta came with the probe's bucket read (0
        # for new rows).
        touch = (FLAG_TOUCH_BOTH if mark_delta
                 else torch.where(newly, FLAG_TOUCH_BOTH, 0))
        upd_meta = packing.saturating_add_freq(fr.meta, counts, day) | touch
        if not (defer_meta and table.config.enter_threshold == 0):
            _set_meta_at(header, torch.where(ok, placed, table.capacity),
                         upd_meta)

    new_table = dataclasses.replace(table, header=header, payload=payload)
    with profiling.annotate("tfp::gather"):
        prow = _gather_payload(new_table, placed, ok)
        rows = _rows_view(new_table, prow, ok, upd_meta)
    return LookupResult(rows=rows, slot=torch.where(ok, placed, -1),
                        table=new_table, overflow=overflow,
                        payload_rows=prow, meta_rows=upd_meta)


def lookup_or_zeros(table: KvTable, q: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference-path gather: unknown / blacklisted keys read as zeros."""
    fr = find(table, q, valid)
    return _gather_rows(table, fr.slot, fr.found, fr.meta)


def lookup_with_init(table: KvTable, q: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather with init-pool fallback for misses, **without inserting**."""
    fr = find(table, q, valid)
    rows = _gather_rows(table, fr.slot, fr.found, fr.meta)
    miss = _valid_keys(q, valid) & ~fr.found
    return torch.where(miss[:, None], _init_rows_for(table, q), rows)


# ---------------------------------------------------------------------------
# mutation (all in place)
# ---------------------------------------------------------------------------

def _place(table: KvTable, q: torch.Tensor, valid: Optional[torch.Tensor]):
    """find + claim-insert of the misses: ``(fr, placed, ok)``."""
    valid = _valid_keys(q, valid)
    fr = find(table, q, valid)
    _, placed_new = _claim_insert(table.header, q, valid & ~fr.found,
                                  table.config.max_probes)
    placed = torch.where(fr.found, fr.slot, placed_new)
    return fr, placed, valid & (placed >= 0)


def insert(table: KvTable, q: torch.Tensor, rows: torch.Tensor,
           *, valid: Optional[torch.Tensor] = None,
           day=0,
           blacklist: Optional[torch.Tensor] = None,
           freq: Optional[torch.Tensor] = None) -> KvTable:
    """Unconditional upsert of ``q → rows``, in place. Existing rows keep
    their slot columns, frequency and day unless ``freq`` is given; new rows
    get zero slot columns and freq 1. Dedup ``q`` first."""
    n = q.shape[0]
    fr, placed, ok = _place(table, q, valid)
    dim, w = table.config.dim, table.payload.shape[1]
    gidx = torch.where(ok, placed, -1)
    wide = rows.to(table.payload.dtype)
    if w != dim:
        cur = rowops.gather_rows(table.payload, gidx)
        slot_cols = torch.where((fr.found & ok)[:, None], cur[:, dim:],
                                cur.new_zeros((n, w - dim)))
        wide = torch.cat([wide, slot_cols], dim=1)
    rowops.scatter_rows(table.payload, gidx, wide.contiguous())
    day = packing._u32(day).to(q.device).expand(n)
    if freq is None:
        freq = torch.where(fr.found, packing.get_freq(fr.meta), 1)
        day = torch.where(fr.found, packing.get_day(fr.meta), day)
    fl = torch.full((n,), FLAG_TOUCH_BOTH, dtype=torch.int64, device=q.device)
    if blacklist is not None:
        fl = fl | torch.where(blacklist, FLAG_BLACKLIST, 0)
    _set_meta_at(table.header, torch.where(ok, placed, table.capacity),
                 packing.pack(freq, day, fl))
    return table


def insert_raw(table: KvTable, q: torch.Tensor, payload_rows: torch.Tensor,
               meta: torch.Tensor, *,
               valid: Optional[torch.Tensor] = None) -> KvTable:
    """Upsert FULL payload rows (embedding + slot columns) with exact packed
    meta words, in place. ``q`` must be deduplicated."""
    _, placed, ok = _place(table, q, valid)
    rowops.scatter_rows(table.payload, torch.where(ok, placed, -1),
                        payload_rows.to(table.payload.dtype).contiguous())
    _set_meta_at(table.header, torch.where(ok, placed, table.capacity),
                 packing._u32(meta))
    return table


_SCATTER_OPS = {"update": lambda cur, u: u, "add": torch.add,
                "sub": torch.sub, "mul": torch.mul, "div": torch.div,
                "min": torch.minimum, "max": torch.maximum}


def scatter(table: KvTable, q: torch.Tensor, updates: torch.Tensor, op: str,
            *, valid: Optional[torch.Tensor] = None, day=0) -> KvTable:
    """Elementwise scatter family over rows, in place: ``row = op(row,
    update)`` for ``op`` in update/add/sub/mul/div/min/max. Missing keys are
    inserted with init-pool rows first, then the op applies; slot columns
    are kept. A written row is marked touched for both delta streams and
    leaves the blacklist. ``q`` must be deduplicated."""
    if op not in _SCATTER_OPS:
        raise ValueError(f"op must be one of {tuple(_SCATTER_OPS)}")
    # the lookup inserts into table's own header and payload
    res = lookup_or_insert(table, q, valid=valid, day=day)
    ok = res.slot >= 0
    dim = table.config.dim
    # the rows as they were after the inserts: a copy, which the write
    # below cannot change under us
    cur_wide = res.payload_rows
    cur = cur_wide[:, :dim]
    out = _SCATTER_OPS[op](cur, updates.to(device=cur.device,
                                           dtype=cur.dtype))
    wide = torch.cat([out, cur_wide[:, dim:]], dim=1)
    rowops.scatter_rows(table.payload, torch.where(ok, res.slot, -1), wide)
    _set_meta_at(table.header, torch.where(ok, res.slot, table.capacity),
                 (res.meta_rows | FLAG_TOUCH_BOTH) & ~FLAG_BLACKLIST)
    return table


def _log_deletes(table: KvTable, q: torch.Tensor,
                 mask: torch.Tensor) -> KvTable:
    """Append deleted keys to the table's deletion log (for delta export)."""
    rb = table.deleted_keys.shape[0]
    pos = table.deleted_count + torch.cumsum(mask.to(torch.int32), 0) - 1
    keep = mask & (pos < rb)
    table.deleted_keys[pos[keep].long()] = q[keep]
    total = table.deleted_count + mask.sum().to(torch.int32)
    table.deleted_overflow = table.deleted_overflow | (total > rb)
    table.deleted_count = torch.clamp(total, max=rb).to(torch.int32)
    return table


def delete(table: KvTable, q: torch.Tensor,
           valid: Optional[torch.Tensor] = None):
    """Remove keys in place; returns ``(table, deleted_mask)``. Slots become
    tombstones so other keys' buckets stay valid."""
    fr = find(table, q, valid)
    idx = fr.slot[fr.found].long()
    flat = table.header.view(-1)
    flat[_hpos_lo(idx)] = hashing.TOMB_LO
    flat[_hpos_hi(idx)] = hashing.TOMB_HI
    flat[_hpos_meta(idx)] = 0
    table.payload[idx] = 0
    return _log_deletes(table, q, fr.found), fr.found


def delete_with_timestamp(table: KvTable, threshold_days: int, day):
    """Evict, in place, every row untouched for more than ``threshold_days``
    days before ``day`` (ages on the 13-bit day ring). Evicted slots become
    tombstones with meta and pad lanes 0, their payload rows zeros, and
    their keys go to the deletion log. Returns ``(table, evicted_mask[C])``.
    """
    # the keys as they were: the sweep below overwrites them in place
    keys = table.keys
    occ = ~hashing.is_free(keys)
    age = packing.day_age(day, packing.get_day(table.meta))
    evict = occ & (age > threshold_days)
    g = table.header.shape[0]
    v = table.header.view(g, 4, _B)
    repl = torch.tensor([hashing.TOMB_LO, hashing.TOMB_HI, 0, 0],
                        dtype=torch.int32, device=v.device).view(1, 4, 1)
    v.copy_(torch.where(evict.view(g, 1, _B), repl, v))
    table.payload.masked_fill_(evict[:, None], 0)
    return _log_deletes(table, keys, evict), evict


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------

def occupied_mask(table: KvTable) -> torch.Tensor:
    return ~hashing.is_free(table.keys)


def size(table: KvTable) -> torch.Tensor:
    """Number of live rows (int64 scalar tensor)."""
    return occupied_mask(table).sum()


def sum_freq(table: KvTable) -> int:
    """Σ frequency over live rows (exact, int64)."""
    occ = occupied_mask(table)
    return int(torch.where(occ, packing.get_freq(table.meta), 0).sum())


def get_count(table: KvTable, q: torch.Tensor) -> torch.Tensor:
    """Per-key visit frequency, int32 (0 for unknown keys)."""
    fr = find(table, q)
    return torch.where(fr.found, packing.get_freq(fr.meta), 0).to(torch.int32)


def get_timestamp(table: KvTable, q: torch.Tensor) -> torch.Tensor:
    """Per-key last-update day on the 13-bit ring, int32 (0 for unknown
    keys)."""
    fr = find(table, q)
    return torch.where(fr.found, packing.get_day(fr.meta), 0).to(torch.int32)


def stats(table: KvTable) -> dict:
    """Observability snapshot (host-side; cheap reductions)."""
    occ = occupied_mask(table)
    meta = table.meta
    n = int(occ.sum())
    return {
        "name": table.config.name,
        "size": n,
        "capacity": table.capacity,
        "load_factor": n / table.capacity,
        "sum_freq": sum_freq(table),
        "blacklisted": int((occ & ((meta & FLAG_BLACKLIST) != 0)).sum()),
        "delta_pending": int((occ & ((meta & FLAG_TOUCH_TRAIN) != 0)).sum()),
        "deleted_log": int(table.deleted_count),
        "bytes": int(table.payload.numel() * table.payload.element_size()
                     + table.header.numel() * table.header.element_size()),
    }


def load_factor(table: KvTable) -> float:
    return float(size(table)) / table.capacity


def needs_grow(table: KvTable, incoming: int = 0,
               threshold: float = GROW_LOAD_FACTOR) -> bool:
    """Host-side check: will ``incoming`` more rows push past the load factor?"""
    return (int(size(table)) + incoming) > threshold * table.capacity


def ensure_slots(table: KvTable, slot_specs: Dict[str, int]) -> KvTable:
    """Make sure slot segments exist in the payload: ``name -> width
    multiplier k`` appends ``k*dim`` zero columns. Returns a new table when
    the payload widens (the old payload is copied once)."""
    layout = list(table.config.slot_layout)
    have = {name for name, _ in layout}
    extra = 0
    for name, k in slot_specs.items():
        if name not in have:
            layout.append((name, k))
            extra += k * table.dim
    if not extra:
        return table
    payload = torch.cat([table.payload,
                         table.payload.new_zeros(
                             table.payload.shape[:-1] + (extra,))], dim=-1)
    cfg = dataclasses.replace(table.config, slot_layout=tuple(layout))
    return dataclasses.replace(table, payload=payload, config=cfg)




def get_slot(table: KvTable, name: str) -> torch.Tensor:
    """Whole slot segment [C, k*dim] (a view of the payload columns)."""
    s, w = table.config.slot_columns()[name]
    return table.payload[..., s:s + w]


def set_slot_rows(table: KvTable, name: str, idx: torch.Tensor,
                  rows: torch.Tensor) -> KvTable:
    """Overwrite ``rows`` of one slot segment at row indices ``idx``, in
    place (out-of-range indices dropped). Checkpoint-restore helper, not a
    hot path: it gathers and rewrites full payload rows through the row
    kernels."""
    s, w = table.config.slot_columns()[name]
    ok = (idx >= 0) & (idx < table.capacity)
    gidx = torch.where(ok, idx, -1).to(torch.int32)
    cur = rowops.gather_rows(table.payload, gidx)
    cur[:, s:s + w] = rows.to(device=cur.device, dtype=cur.dtype)
    rowops.scatter_rows(table.payload, gidx, cur)
    return table


# ---------------------------------------------------------------------------
# growth / rehash (each returns a NEW table)
# ---------------------------------------------------------------------------

def _move_rows(table: KvTable, header: torch.Tensor, payload: torch.Tensor,
               dst: torch.Tensor) -> None:
    """Copy every old row ``i`` with ``dst[i] >= 0`` to new slot ``dst[i]``:
    its payload row through the row-scatter kernel (-1 rows dropped, as the
    JAX package's ``mode="drop"`` sentinel) and its meta word."""
    rowops.scatter_rows(payload, dst.to(torch.int32), table.payload)
    _set_meta_at(header, torch.where(dst >= 0, dst, payload.shape[0]),
                 table.meta)


def _rehash_core(table: KvTable, new_capacity: int):
    """Generic rehash: claim-insert every live key into an empty table of
    ``new_capacity``. Returns ``(new_table, lost)``, ``lost`` the count of
    live rows that found no slot (a 0-d tensor)."""
    occ = occupied_mask(table)
    header, placed = _claim_insert(
        _empty_header(new_capacity // _B, table.device), table.keys, occ,
        max(table.config.max_probes, 2 * _B))
    payload = table.payload.new_zeros((new_capacity, table.payload.shape[1]))
    _move_rows(table, header, payload, torch.where(occ, placed, -1))
    lost = (occ & (placed < 0)).sum()
    return dataclasses.replace(table, header=header, payload=payload), lost


def _rehash_double_core(table: KvTable, new_capacity: int):
    """Doubling rehash as a bucket-split permutation.

    At 2× capacity both bucket hashes gain one bit, so a row's new bucket is
    its old bucket or that plus ``g`` (the old bucket count): every new
    bucket receives a subset of exactly one old bucket's ≤ 16 rows, ranked
    by a per-bucket exclusive cumsum, with no claim rounds. Rows outside
    both computed choices (the rare ``b2 == b1 → +1`` adjustment edge)
    spill into one claim-insert pass; that pass is gated on one boolean
    read. Returns ``(new_table, lost)`` like :func:`_rehash_core`.
    """
    cap = table.capacity
    assert new_capacity == 2 * cap
    dev = table.device
    occ = occupied_mask(table)
    keys = table.keys
    g_old = cap // _B
    b1o, b2o = hashing.bucket_choices(keys, cap)
    b1n, b2n = hashing.bucket_choices(keys, new_capacity)
    slot_bucket = torch.arange(cap, device=dev) // _B
    via1 = slot_bucket == b1o
    via2 = ~via1 & (slot_bucket == b2o)
    target = torch.where(via1, b1n, torch.where(via2, b2n, -1))
    beta = target == slot_bucket + g_old              # high-half bit
    in_split = occ & ((target == slot_bucket) | beta)
    ind0 = (in_split & ~beta).view(g_old, _B).to(torch.int32)
    ind1 = (in_split & beta).view(g_old, _B).to(torch.int32)
    r0 = ind0.cumsum(1) - ind0                        # exclusive rank ≤ 15
    r1 = ind1.cumsum(1) - ind1
    lane = torch.where(beta, r1.view(-1), r0.view(-1))
    placed = torch.where(in_split, target * _B + lane, -1)

    header = _empty_header(new_capacity // _B, dev)
    flat = header.view(-1)
    d = placed[in_split]
    flat[_hpos_lo(d)] = keys[in_split, 0]
    flat[_hpos_hi(d)] = keys[in_split, 1]
    payload = table.payload.new_zeros((new_capacity, table.payload.shape[1]))
    _move_rows(table, header, payload, placed)
    out = dataclasses.replace(table, header=header, payload=payload)

    spill = occ & (placed < 0)
    if not bool(spill.any()):
        return out, torch.zeros((), dtype=torch.int64, device=dev)
    _, placed2 = _claim_insert(header, keys, spill,
                               max(table.config.max_probes, 2 * _B))
    _move_rows(table, header, payload, torch.where(spill, placed2, -1))
    return out, (spill & (placed2 < 0)).sum()


def _rehash_core_fast(table: KvTable, target: int):
    """Best-path rehash to ``target``: chained doublings for growth, the
    generic claim rehash for a same-size rebuild (compaction)."""
    if target == table.capacity:
        return _rehash_core(table, target)
    t = table
    lost = torch.zeros((), dtype=torch.int64, device=table.device)
    while t.capacity < target:
        t, n = _rehash_double_core(t, t.capacity * 2)
        lost = lost + n
    return t, lost


def _rehash_verified(table: KvTable, new_capacity: int) -> KvTable:
    """Rehash, but never lose rows: if a rebuild places fewer rows than
    the table holds (a pathological bucket-pair collision), rebuild from
    the ORIGINAL table at twice the capacity, at most 5 times."""
    before = int(size(table))
    cap = new_capacity
    for _ in range(5):
        out, _ = _rehash_core_fast(table, cap)
        if int(size(out)) == before:
            return out
        del out
        cap *= 2
    raise RuntimeError(
        f"rehash lost rows even at {cap // 2}x capacity ({before} live)")


def grow(table: KvTable, new_capacity: Optional[int] = None) -> KvTable:
    """Growth between steps: a NEW table at 2× (or the given) capacity
    holding every live row."""
    new_capacity = new_capacity or table.capacity * 2
    if new_capacity & (new_capacity - 1):
        raise ValueError("new_capacity must be a power of two")
    if new_capacity < table.capacity:
        raise ValueError("cannot shrink below current capacity")
    return _rehash_verified(table, new_capacity)


def grow_to_fit(table: KvTable, incoming: int = 0,
                threshold: float = GROW_LOAD_FACTOR) -> KvTable:
    """Grow by as many doublings as needed so that the current rows plus
    ``incoming`` sit under the load factor. Returns ``table`` itself when it
    already fits, else a NEW table."""
    cur = int(size(table))
    cap = table.capacity
    while (cur + incoming) > threshold * cap:
        cap *= 2
    if cap == table.capacity:
        return table
    return _rehash_verified(table, cap)


def compact(table: KvTable) -> KvTable:
    """A NEW table rebuilt at the same capacity without tombstones (grows
    instead if the rebuild cannot place every row)."""
    return _rehash_verified(table, table.capacity)


# ---------------------------------------------------------------------------
# delta streams
# ---------------------------------------------------------------------------

def _consume_deletes(table: KvTable, deltalist: str) -> KvTable:
    """Advance ``deltalist``'s watermark past the deletion log, in place.

    Without ``config.support_prediction_delta`` the log simply resets. With
    it, entries stay until BOTH streams have exported them; fully consumed
    entries compact away, and the overflow flag clears only once no stream
    has entries pending."""
    dev = table.device

    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=dev)

    if not table.config.support_prediction_delta:
        table.deleted_keys = torch.full_like(table.deleted_keys,
                                             hashing.EMPTY_LO)
        table.deleted_count = scalar(0)
        table.deleted_overflow = scalar(False, torch.bool)
        table.deleted_seen_train = scalar(0)
        table.deleted_seen_pred = scalar(0)
        return table
    count = int(table.deleted_count)
    seen_t = count if deltalist == "train" else int(table.deleted_seen_train)
    seen_p = count if deltalist == "pred" else int(table.deleted_seen_pred)
    keep_from = min(seen_t, seen_p)
    rb = table.deleted_keys.shape[0]
    live = torch.arange(rb, device=dev)[:, None] < (count - keep_from)
    table.deleted_keys = torch.where(
        live, torch.roll(table.deleted_keys, -keep_from, 0),
        hashing.EMPTY_LO).to(torch.int32)
    table.deleted_count = scalar(count - keep_from)
    table.deleted_overflow = table.deleted_overflow & (count > keep_from)
    table.deleted_seen_train = scalar(seen_t - keep_from)
    table.deleted_seen_pred = scalar(seen_p - keep_from)
    return table


def pending_delete_span(table: KvTable, deltalist: str = "train"):
    """(start, count) of the deletion-log entries pending for this stream."""
    start = (table.deleted_seen_train if deltalist == "train"
             else table.deleted_seen_pred)
    return start, table.deleted_count


def clear_deltalist(table: KvTable, deltalist: str = "train") -> KvTable:
    """Reset this stream's delta-touch bits and consume its deletion log,
    in place (the reference's deltalist swap on export)."""
    bit = FLAG_TOUCH_TRAIN if deltalist == "train" else FLAG_TOUCH_PRED
    _set_all_meta(table.header, table.meta & ~bit)
    return _consume_deletes(table, deltalist)


# ---------------------------------------------------------------------------
# host-side export / import (feeds tfplus_tpu_torch.checkpoint)
# ---------------------------------------------------------------------------

def _occupied_np(keys: np.ndarray) -> np.ndarray:
    return ~(((keys[:, 0] == hashing.EMPTY_LO)
              | (keys[:, 0] == hashing.TOMB_LO))
             & (keys[:, 1] == hashing.EMPTY_HI))


def export_arrays(table: KvTable, *, enable_cutoff: bool = False,
                  cutoff_value: float = 1e-20,
                  delta: bool = False,
                  deltalist: str = "train",
                  clear_deltalist: Optional[bool] = None,
                  as_of_unix_day: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The table's logical checkpoint tensors on the host, as the JAX
    package's ``export_arrays`` gives them: ``keys`` (uint64), ``values``
    (f32[n, D]), ``init_table``, ``blacklist``, ``freq_keys``/
    ``freq_values`` (uint16) and ``meta``, the reference's ``freq |
    unix_day<<16`` word. The selected rows come through the row-gather
    kernel. ``delta=True`` keeps the rows this stream touched and adds its
    pending ``delete_keys`` and ``need_full_import``; clearing (the default
    with ``delta``) updates the table in place and returns it under
    ``"table"``. ``enable_cutoff`` drops rows with max|v| < cutoff
    (blacklisted rows keep their keys)."""
    dim = table.config.dim
    keys = table.keys.cpu().numpy()
    meta = table.meta.cpu().numpy().astype(np.uint32)
    occ = _occupied_np(keys)
    sel = occ
    if delta:
        bit = FLAG_TOUCH_TRAIN if deltalist == "train" else FLAG_TOUCH_PRED
        sel = sel & ((meta & np.uint32(bit)) != 0)
    black = (meta & np.uint32(FLAG_BLACKLIST)) != 0
    if enable_cutoff:
        vmax = table.payload[:, :dim].abs().amax(dim=1).float().cpu().numpy()
        sel = sel & ((vmax >= cutoff_value) | black)
    idx = torch.from_numpy(np.nonzero(sel)[0].astype(np.int32))
    values = rowops.gather_rows(table.payload, idx.to(table.device))[:, :dim]
    out_keys = hashing.decode_ids_np(keys[sel])
    out = {
        "keys": out_keys,
        "values": values.float().cpu().numpy(),
        "init_table": table.init_pool.float().cpu().numpy(),
        "blacklist": hashing.decode_ids_np(keys[occ & black]),
        "freq_keys": out_keys,
        "freq_values": (meta[sel] & packing.FREQ_MASK).astype(np.uint16),
        "meta": packing.reference_word_np(meta, as_of_unix_day)[sel],
    }
    if delta:
        start, count = pending_delete_span(table, deltalist)
        dk = table.deleted_keys.cpu().numpy()
        out["delete_keys"] = hashing.decode_ids_np(dk[int(start):int(count)])
        out["need_full_import"] = bool(table.deleted_overflow)
    if clear_deltalist is None:
        clear_deltalist = delta
    if clear_deltalist:
        bit = FLAG_TOUCH_TRAIN if deltalist == "train" else FLAG_TOUCH_PRED
        _set_all_meta(table.header, table.meta & ~bit)
        out["table"] = _consume_deletes(table, deltalist)
    return out


def import_arrays(table: KvTable, data: Dict[str, np.ndarray], *,
                  clear: bool = True, delete_keys: Optional[np.ndarray] = None,
                  day: Optional[int] = None) -> KvTable:
    """Load exported tensors back (the :func:`export_arrays` format).
    ``clear=True`` starts from a NEW empty table with the data's init pool;
    ``clear=False`` upserts into ``table`` (delta/merge semantics). Grows as
    needed before inserting, and grows and re-inserts (at most 4 times) when
    a bucket pair overflows: an import never places fewer rows than given.
    """
    n = int(np.asarray(data["keys"]).shape[0])
    dev = table.device
    if clear:
        pool = data.get("init_table")
        fresh = create(table.dim, table.capacity,
                       initializer=(table.init_pool if pool is None
                                    else torch.as_tensor(np.asarray(pool))),
                       enter_threshold=table.config.enter_threshold,
                       max_probes=table.config.max_probes,
                       value_dtype=table.config.value_dtype,
                       name=table.config.name, device=dev)
        table = ensure_slots(fresh, dict(table.config.slot_layout))
    cap = table.capacity
    cur = 0 if clear else int(size(table))
    while (cur + n) > GROW_LOAD_FACTOR * cap:
        cap *= 2
    if cap != table.capacity:
        table = grow(table, cap)

    # deletes FIRST, then upserts: a key deleted and re-inserted between
    # exports appears in both lists, and the upsert must win
    if delete_keys is not None and np.asarray(delete_keys).size:
        qd = hashing.encode_ids_np_to_device(np.asarray(delete_keys), dev)
        table, _ = delete(table, qd)

    if n:
        q = hashing.encode_ids_np_to_device(np.asarray(data["keys"]), dev)
        vals = torch.as_tensor(np.asarray(data["values"])).to(
            device=dev, dtype=table.payload.dtype)
        freq = np.zeros((n,), np.uint32)
        if "meta" in data:
            meta_in = np.asarray(data["meta"], dtype=np.uint32)
            freq = meta_in & packing.FREQ_MASK
            days = meta_in >> 16
        else:
            if ("freq_values" in data
                    and len(np.asarray(data["freq_values"])) == n):
                freq = np.asarray(data["freq_values"]).astype(np.uint32)
            days = np.full((n,), day if day is not None
                           else packing.current_day(), np.uint32)
        black_np = np.zeros((n,), bool)
        bl = np.asarray(data.get("blacklist", np.zeros((0,), np.uint64)))
        if bl.size:
            black_np = np.isin(np.asarray(data["keys"]).astype(np.uint64),
                               bl.astype(np.uint64))
        freq_t = torch.from_numpy(freq.astype(np.int64)).to(dev)
        black_t = torch.from_numpy(black_np).to(dev)
        table = insert(table, q, vals, freq=freq_t, blacklist=black_t, day=0)
        # a bucket pair can overflow under the load factor; a restore must
        # never lose rows: grow (which disperses the pair) and re-insert
        # (idempotent: values, freq and flags are set, not accumulated)
        fr = find(table, q)
        for _ in range(4):
            if not bool((~fr.found).any()):
                break
            table = grow(table)
            table = insert(table, q, vals, freq=freq_t, blacklist=black_t,
                           day=0)
            fr = find(table, q)
        else:
            raise RuntimeError(f"import could not place "
                               f"{int((~fr.found).sum())} rows after 4 grows")
        # overwrite meta with exact packed values (restores per-row day,
        # keeps the just-set touch/blacklist flag bits)
        fl = (packing.FLAG_TOUCH_BOTH
              | np.where(black_np, packing.FLAG_BLACKLIST, 0).astype(np.int64))
        packed = (((days.astype(np.int64) & packing.DAY_MASK) << 16)
                  | (freq.astype(np.int64) & packing.FREQ_MASK) | fl)
        _set_meta_at(table.header, fr.slot, torch.from_numpy(packed).to(dev))
    return table
