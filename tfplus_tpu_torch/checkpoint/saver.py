"""Checkpoint save/restore for KvTables and dense state.

Counterpart of ``tfplus_tpu/checkpoint/saver.py``, writing and reading the
same bundles: per table shard the reference's logical tensors ``<var>-keys``,
``-values``, ``-init_table``, ``-blacklist``, ``-freq_keys`` (an alias of
``-keys``), ``-freq_values``, the packed ``-meta`` word and, for deltas,
``-need_full_import`` and ``-delete_keys``, with ``first_n`` selecting how
many are written (2 = kv only, 3 = inference, 4 = +blacklist, 6 = train,
8 = delta). Optimizer slot columns go under ``<var>-slot-<name>``. Sharded
tables use ``name/part_i`` and re-shard on restore by ``key % num_shards``
(repartition.py).

Values and slot columns stream between the device and the bundle in
bounded chunks: the save gathers each chunk's rows through the row-gather
kernel, and the restore upserts chunk by chunk with the JAX package's chunk
sizes, so a restored table is bit-identical to the JAX package's restore.

Dense state is an ``nn.Module`` (its state-dict name ``dnn.0.w`` is saved as
``dense/dnn/0/w``, the name the JAX package gives the same leaf of its
parameter pytree) or a nested dict of tensors or arrays (``dense/<a>/<b>``).
A restore loads a module IN PLACE, so an optimizer built over its
parameters stays bound to them.

Tables update in place here as everywhere in the port: a save that clears
delta bits clears them on the tables given and returns them; a restore
returns NEW tables.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..kv import hashing
from ..kv import table as kvt
from ..ops import rowops
from ..utils import packing
from . import bundle

# Streaming budget: values and slots move device → host → disk in chunks of
# about this many bytes; the control plane (keys + packed meta, 12 B/row) is
# materialised whole.
DEFAULT_CHUNK_BYTES = 256 << 20


def _chunk_rows(row_bytes: int, chunk_rows: Optional[int]) -> int:
    if chunk_rows:
        return int(chunk_rows)
    return max(1024, DEFAULT_CHUNK_BYTES // max(int(row_bytes), 1))


# saver modes (set_tfplus_saver_mode: 0 = prediction/inference, 1 = training)
FIRST_N_KV = 2
FIRST_N_INFERENCE = 3
FIRST_N_BLACKLIST = 4
FIRST_N_TRAIN = 6
FIRST_N_DELTA = 8

TableOrShards = Union[kvt.KvTable, Sequence[kvt.KvTable]]


def _shards(t: TableOrShards) -> List[kvt.KvTable]:
    return list(t) if isinstance(t, (list, tuple)) else [t]


def shard_name(name: str, i: int, n: int) -> str:
    return name if n == 1 else f"{name}/part_{i}"


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _on(arr: np.ndarray, device) -> torch.Tensor:
    """A host array (possibly a read-only view of a bundle buffer) as a
    tensor on ``device``."""
    return torch.from_numpy(np.array(arr)).to(device)


def _restore_import_chunk(table: kvt.KvTable, q, vals, freq, days,
                          black) -> int:
    """Upsert one chunk with exact per-row freq and day, in place; returns
    how many valid keys found no slot."""
    kvt.insert(table, q, vals, freq=freq, blacklist=black, day=days)
    valid = ~hashing.is_reserved_id(q)
    return int((valid & ~kvt.find(table, q, valid).found).sum())


def _restore_slot_chunk(table: kvt.KvTable, q, rows, sname: str):
    fr = kvt.find(table, q)
    return kvt.set_slot_rows(table, sname, torch.where(fr.found, fr.slot, -1),
                             rows)


def _stream_payload_cols(writer, tensor_name: str, table: kvt.KvTable,
                         idx: np.ndarray, col0: int, ncols: int,
                         chunk_rows: Optional[int]):
    """Stream payload columns ``[col0, col0+ncols)`` of rows ``idx`` into the
    bundle in bounded chunks, each gathered on the device first."""
    n = len(idx)
    writer.add_header(tensor_name, np.float32, (n, ncols))
    cr = _chunk_rows(ncols * 4, chunk_rows)
    rows_idx = torch.from_numpy(idx.astype(np.int32)).to(table.device)
    for a in range(0, n, cr):
        part = rowops.gather_rows(table.payload, rows_idx[a:a + cr])
        writer.append_segment(
            part[:, col0:col0 + ncols].float().cpu().numpy())
    writer.end_segment()


def save_table(writer: bundle.BundleWriter, name: str, table: kvt.KvTable, *,
               first_n: int = FIRST_N_TRAIN, delta: bool = False,
               enable_cutoff: bool = False, cutoff_value: float = 1e-20,
               delete_keys: Optional[np.ndarray] = None,
               save_slots: bool = True,
               chunk_rows: Optional[int] = None,
               as_of_unix_day: Optional[int] = None) -> kvt.KvTable:
    """Write one table (shard) and return it. A delta save clears the train
    stream's delta bits and deletion log, and a full save with ``first_n >
    2`` resets a stream's baseline, both in place on ``table``.

    Values and slot columns stream through bounded host chunks
    (``chunk_rows``, default ~256 MB worth); only the 12 B/row control
    plane (keys + packed meta) is materialised whole."""
    dim = table.config.dim
    keys = table.keys.cpu().numpy()
    meta = table.meta.cpu().numpy().astype(np.uint32)
    occ = kvt._occupied_np(keys)
    sel = occ
    if delta:
        sel = sel & ((meta & np.uint32(kvt.FLAG_TOUCH_TRAIN)) != 0)
    black = (meta & np.uint32(kvt.FLAG_BLACKLIST)) != 0
    if enable_cutoff:
        # per-row max|v| reduces on the device: [C] to the host, not [C, D]
        vmax = table.payload[:, :dim].abs().amax(dim=1).float().cpu().numpy()
        sel = sel & ((vmax >= cutoff_value) | black)  # blacklist rows survive
    idx = np.nonzero(sel)[0]

    writer.add(name + "-keys", hashing.decode_ids_np(keys[sel]))
    _stream_payload_cols(writer, name + "-values", table, idx, 0, dim,
                         chunk_rows)
    if first_n >= FIRST_N_INFERENCE and not delta:
        # a delta restore never reads -init_table
        writer.add(name + "-init_table",
                   table.init_pool.float().cpu().numpy())
    if first_n >= FIRST_N_BLACKLIST:
        writer.add(name + "-blacklist",
                   hashing.decode_ids_np(keys[occ & black]))
    if first_n >= FIRST_N_TRAIN:
        writer.add_alias(name + "-freq_keys", name + "-keys")
        writer.add(name + "-freq_values",
                   (meta[sel] & packing.FREQ_MASK).astype(np.uint16))
        writer.add(name + "-meta",
                   packing.reference_word_np(meta[sel], as_of_unix_day))
    if first_n >= FIRST_N_DELTA or delta:
        if delta:
            # the saver writes the TRAIN stream: its pending deletion span
            start, count = kvt.pending_delete_span(table, "train")
            need_full = bool(table.deleted_overflow)
            dk_own = hashing.decode_ids_np(
                table.deleted_keys.cpu().numpy()[int(start):int(count)])
        else:
            need_full, dk_own = True, np.zeros((0,), np.uint64)
        writer.add(name + "-need_full_import",
                   np.array([1 if need_full else 0], np.int8))
        dk = delete_keys if delete_keys is not None else dk_own
        writer.add(name + "-delete_keys", np.asarray(dk, np.uint64))
    if save_slots and first_n >= FIRST_N_TRAIN:
        # optimizer slot rows for the same exported keys (train resume)
        for sname, (s, w) in table.config.slot_columns().items():
            _stream_payload_cols(writer, f"{name}-slot-{sname}", table, idx,
                                 s, w, chunk_rows)
    if delta:
        table = kvt.clear_deltalist(table, "train")
    elif first_n > FIRST_N_KV:
        # a full export resets the delta baseline (first_n <= 4 clears the
        # prediction list, else the train list)
        table = kvt.clear_deltalist(
            table, "pred" if first_n <= FIRST_N_BLACKLIST else "train")
    return table


def restore_table(reader: bundle.BundleReader, name: str,
                  template: kvt.KvTable, *, delta: bool = False,
                  chunk_rows: Optional[int] = None,
                  load_slots: bool = True) -> kvt.KvTable:
    """Load one table (shard). A full restore starts from a NEW empty table
    shaped like ``template`` (its capacity, options and slot layout, the
    checkpoint's init pool) on ``template``'s device; a delta restore
    upserts into ``template`` itself. Grows the table before inserting so
    that every row fits under the load factor, and grows again and re-runs
    the (idempotent) upsert pass if a bucket pair overflows: a restore never
    loses rows. Values and slot rows stream in bounded chunks of the JAX
    package's sizes."""
    if delta and name + "-need_full_import" in reader:
        if int(np.asarray(reader.lookup(name + "-need_full_import"))[0]):
            raise ValueError(
                f"delta checkpoint for '{name}' was exported after its "
                "deletion log overflowed (need_full_import=1); its delete "
                "list is incomplete — restore from a full checkpoint instead")
    keys = np.asarray(reader.lookup(name + "-keys"))
    n = len(keys)
    meta = (np.asarray(reader.lookup(name + "-meta"))
            if name + "-meta" in reader else None)
    freq = (np.asarray(reader.lookup(name + "-freq_values"))
            if meta is None and name + "-freq_values" in reader else None)
    blacklist = (np.asarray(reader.lookup(name + "-blacklist"))
                 if name + "-blacklist" in reader
                 else np.zeros((0,), np.uint64))
    init_table = (reader.lookup(name + "-init_table")
                  if name + "-init_table" in reader else None)
    delete_keys = (reader.lookup(name + "-delete_keys")
                   if name + "-delete_keys" in reader else None)

    dev = template.device
    table = template
    if not delta:
        table = kvt.create(
            template.dim, template.capacity,
            initializer=(template.init_pool if init_table is None
                         else torch.from_numpy(np.array(init_table))),
            enter_threshold=template.config.enter_threshold,
            max_probes=template.config.max_probes,
            value_dtype=template.config.value_dtype,
            name=template.config.name,
            support_prediction_delta=template.config.support_prediction_delta,
            device=dev)
        table = kvt.ensure_slots(table, dict(template.config.slot_layout))
    if delete_keys is not None and np.asarray(delete_keys).size:
        qd = hashing.encode_ids_np_to_device(np.asarray(delete_keys), dev)
        table, _ = kvt.delete(table, qd)

    # claim-insert placement depends on which keys go in together: the
    # chunk is the JAX package's (clamped to the next power of two >= n)
    cr = min(_chunk_rows(table.dim * 4, chunk_rows), _next_pow2(n or 1))
    vname = name + "-values"
    if n:
        # grow ONCE to fit every incoming row
        cap = table.capacity
        cur = 0 if not delta else int(kvt.size(table))
        while (cur + n) > kvt.GROW_LOAD_FACTOR * cap:
            cap *= 2
        if cap != table.capacity:
            table = kvt.grow(table, cap)

        day_now = np.uint32(packing.current_day() & packing.DAY_MASK)
        bl_u64 = blacklist.astype(np.uint64) if blacklist.size else None

        def chunk_aux(start: int, rows: int):
            """(freq, days, black) of one chunk, as tensors on the device."""
            if meta is not None:
                m = meta[start:start + rows].astype(np.uint32)
                fq, dy = m & packing.FREQ_MASK, m >> 16
            elif freq is not None:
                fq = freq[start:start + rows].astype(np.uint32)
                dy = np.full((rows,), day_now, np.uint32)
            else:
                fq = np.zeros((rows,), np.uint32)
                dy = np.full((rows,), day_now, np.uint32)
            bk = (np.isin(keys[start:start + rows].astype(np.uint64), bl_u64)
                  if bl_u64 is not None else np.zeros((rows,), bool))
            return (_on(fq.astype(np.int64), dev), _on(dy.astype(np.int64), dev),
                    _on(bk, dev))

        def value_pass(table):
            """One full streamed upsert pass; returns (table, missing)."""
            missing = 0
            for start, vals in reader.stream(vname, cr):
                rows = len(vals)
                q = hashing.encode_ids_np_to_device(keys[start:start + rows],
                                                    dev)
                missing += _restore_import_chunk(
                    table, q, _on(np.asarray(vals, np.float32), dev),
                    *chunk_aux(start, rows))
            return table, missing

        table, missing = value_pass(table)
        for _ in range(4):
            if not missing:
                break
            table = kvt.grow(table)
            table, missing = value_pass(table)
        else:
            raise RuntimeError(
                f"restore could not place {missing} rows after 4 grows")

    # optimizer slot rows, streamed per chunk. load_slots=False drops them
    # (a serving table must not widen with trainer optimizer state)
    slot_names = [k[len(name) + 6:] for k in reader.keys()
                  if k.startswith(name + "-slot-")] if load_slots else []
    if slot_names and n:
        for sname in slot_names:
            tname = f"{name}-slot-{sname}"
            k = reader.shape(tname)[1] // table.dim
            if sname not in table.config.slot_columns():
                table = kvt.ensure_slots(table, {sname: k})
            scr = min(_chunk_rows(k * table.dim * 4, chunk_rows),
                      _next_pow2(n))
            for start, rows in reader.stream(tname, scr):
                q = hashing.encode_ids_np_to_device(
                    keys[start:start + len(rows)], dev)
                table = _restore_slot_chunk(
                    table, q, _on(np.asarray(rows, np.float32), dev), sname)
    return table


# ---------------------------------------------------------------------------
# dense state
# ---------------------------------------------------------------------------

def _path_str(p) -> str:
    return re.sub(r"[^\w.\-]", "_", str(p))


def _flatten(tree, path=()):
    """{path tuple: leaf} of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, path + (k,)))
    return out


def _dense_leaves(dense) -> Dict[str, object]:
    """``{bundle key: leaf}``: a module's state dict (``dnn.0.w`` →
    ``dense/dnn/0/w``) or a nested dict's paths."""
    if isinstance(dense, nn.Module):
        flat = {tuple(k.split(".")): v for k, v in dense.state_dict().items()}
    else:
        flat = _flatten(dense)
    return {"dense/" + "/".join(_path_str(p) for p in path): leaf
            for path, leaf in flat.items()}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore_dense(reader, dense):
    """Dense state from the bundle: a module is loaded in place and
    returned; a dict comes back as a new dict of the same structure and
    leaf types. Leaves the bundle lacks keep the caller's values."""
    leaves = _dense_leaves(dense)
    if isinstance(dense, nn.Module):
        with torch.no_grad():
            for key, t in leaves.items():
                if key in reader:
                    t.copy_(torch.from_numpy(np.array(reader.lookup(key)))
                            .reshape(t.shape))
        return dense

    def load(tree, path=()):
        if isinstance(tree, dict):
            return {k: load(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, path + (i,)) for i, v in enumerate(tree))
        key = "dense/" + "/".join(_path_str(p) for p in path)
        if key not in reader:
            return tree
        arr = np.array(reader.lookup(key))
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr).to(device=tree.device,
                                            dtype=tree.dtype).reshape(tree.shape)
        return arr.astype(np.asarray(tree).dtype).reshape(np.shape(tree))
    return load(dense)


def _save_into(w, tables: Dict[str, TableOrShards],
               dense, *, first_n: int, delta: bool,
               enable_cutoff: bool, cutoff_value: float,
               chunk_rows: Optional[int] = None
               ) -> Dict[str, TableOrShards]:
    """Write every tensor through ``w.add`` (a BundleWriter or collector)."""
    out: Dict[str, TableOrShards] = {}
    for name, t in tables.items():
        shards = _shards(t)
        ns = len(shards)
        new_shards = [
            save_table(w, shard_name(name, i, ns), s, first_n=first_n,
                       delta=delta, enable_cutoff=enable_cutoff,
                       cutoff_value=cutoff_value, chunk_rows=chunk_rows)
            for i, s in enumerate(shards)
        ]
        w.add(name + "-num_shards", np.array([ns], np.int32))
        out[name] = (new_shards if isinstance(t, (list, tuple))
                     else new_shards[0])
    if dense is not None:
        for key, leaf in _dense_leaves(dense).items():
            w.add(key, _host(leaf))
    return out


def save(prefix: str, tables: Dict[str, TableOrShards],
         dense=None, *, first_n: int = FIRST_N_TRAIN,
         delta: bool = False, num_file_shards: int = 1,
         enable_cutoff: bool = False,
         cutoff_value: float = 1e-20,
         chunk_rows: Optional[int] = None) -> Dict[str, TableOrShards]:
    """Save all tables (+ optional dense state) under ``prefix``. Returns
    the tables, same structure as the input (a delta save cleared their
    delta bits in place)."""
    with bundle.BundleWriter(prefix, num_file_shards) as w:
        return _save_into(w, tables, dense, first_n=first_n, delta=delta,
                          enable_cutoff=enable_cutoff,
                          cutoff_value=cutoff_value, chunk_rows=chunk_rows)


class _Collector:
    """Buffers (name, host array) pairs for a deferred bundle write, with
    the writer's streaming surface too. Arrays are copied: a host array may
    share memory with a tensor that training goes on updating."""

    def __init__(self):
        self.items: List[tuple] = []
        self._open: Optional[tuple] = None

    def add(self, name: str, array: np.ndarray):
        self.items.append(("add", name, np.array(array)))

    def add_alias(self, name: str, target: str):
        self.items.append(("alias", name, target))

    def add_header(self, name: str, dtype, shape, shard=None):
        if self._open is not None:
            raise RuntimeError("previous stream not ended")
        self._open = (name, np.dtype(dtype), tuple(shape), [])

    def append_segment(self, array_or_bytes):
        name, dt, shape, chunks = self._open
        a = (np.array(array_or_bytes) if isinstance(array_or_bytes, np.ndarray)
             else np.frombuffer(bytes(array_or_bytes), dtype=dt))
        chunks.append(np.ascontiguousarray(a).reshape(-1))

    def end_segment(self):
        name, dt, shape, chunks = self._open
        arr = (np.concatenate(chunks) if chunks
               else np.zeros((0,), dt)).astype(dt, copy=False).reshape(shape)
        self.items.append(("add", name, arr))
        self._open = None


class AsyncSave:
    """Handle for a background checkpoint write (``save_async``)."""

    def __init__(self, thread, box):
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None):
        """Block until the write finishes; re-raises writer errors."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still running")
        if self._box.get("exc") is not None:
            raise self._box["exc"]
        return self._box.get("value")


def save_async(prefix: str, tables: Dict[str, TableOrShards],
               dense=None, *, first_n: int = FIRST_N_TRAIN,
               delta: bool = False, num_file_shards: int = 1,
               enable_cutoff: bool = False, cutoff_value: float = 1e-20
               ) -> tuple:
    """Non-blocking save: the exports and device → host copies happen NOW
    (the returned tables carry the cleared delta bits, and training may go
    on), while the disk write runs in a background thread. The index publish
    stays atomic. Returns ``(tables, AsyncSave)``; call ``.result()`` before
    relying on the checkpoint."""
    col = _Collector()
    out = _save_into(col, tables, dense, first_n=first_n, delta=delta,
                     enable_cutoff=enable_cutoff, cutoff_value=cutoff_value)
    box: dict = {"exc": None, "value": None}

    def _write():
        try:
            with bundle.BundleWriter(prefix, num_file_shards) as w:
                for kind, name, payload in col.items:
                    if kind == "alias":
                        w.add_alias(name, payload)
                    else:
                        w.add(name, payload)
            box["value"] = prefix
        except BaseException as e:   # surfaced via .result()
            box["exc"] = e

    th = threading.Thread(target=_write, name=f"ckpt-write:{prefix}",
                          daemon=True)
    th.start()
    return out, AsyncSave(th, box)


def restore(prefix: str, tables: Dict[str, TableOrShards],
            dense=None, *, delta: bool = False,
            chunk_rows: Optional[int] = None):
    """Restore tables saved by :func:`save` (by either package) into
    templates shaped like ``tables``, re-sharding when the checkpoint's
    shard count differs (repartition.py). Returns ``(tables, dense)``: NEW
    tables (a delta restore upserts into the templates), and the dense state
    loaded as :func:`_restore_dense` says (None when ``dense`` is None)."""
    from . import repartition
    from ..utils.progress import ProgressBar, MIN_ROWS_FOR_BAR
    reader = (prefix if hasattr(prefix, "lookup")     # any reader-like
              else bundle.BundleReader(prefix))
    out: Dict[str, TableOrShards] = {}
    for name, t in tables.items():
        want = _shards(t)
        n_want = len(want)
        n_ckpt = int(reader.lookup(name + "-num_shards")[0]) \
            if name + "-num_shards" in reader else 1
        ckpt_rows = sum(
            reader.num_elements(shard_name(name, i, n_ckpt) + "-keys") or 0
            for i in range(n_ckpt)) if hasattr(reader, "num_elements") else 0
        bar = ProgressBar(f"restore {name}", total=max(n_want, 1),
                          enabled=None if ckpt_rows >= MIN_ROWS_FOR_BAR
                          else False)
        if n_ckpt == n_want:
            shards = []
            for i in range(n_want):
                shards.append(restore_table(
                    reader, shard_name(name, i, n_want), want[i],
                    delta=delta, chunk_rows=chunk_rows))
                bar.update(1)
        else:
            shards = repartition.restore_repartitioned(
                reader, name, want, n_ckpt, delta=delta,
                chunk_rows=chunk_rows)
            bar.update(n_want)
        bar.done()
        out[name] = shards if isinstance(t, (list, tuple)) else shards[0]
    new_dense = None if dense is None else _restore_dense(reader, dense)
    return out, new_dense


# ---------------------------------------------------------------------------
# Multi-process checkpointing without a coordinator: every process writes
# its OWN bundle with globally numbered table shards; restore reads the
# union. Needs only a shared filesystem, no collectives.
# ---------------------------------------------------------------------------

def _proc_prefix(prefix: str, process_id: int, num_processes: int) -> str:
    return f"{prefix}-proc{process_id:05d}-of-{num_processes:05d}"


class UnionReader:
    """Reader-like union over every process's bundle of a multihost save,
    resolved through the filesystem registry."""

    def __init__(self, prefix: str):
        from ..io.filesystem import get_filesystem
        fs, p = get_filesystem(prefix)
        d, base = p.rsplit("/", 1) if "/" in p else ("", p)
        scheme = prefix[:-len(p)]                 # "" or "<scheme>://"
        pat = re.compile(re.escape(base) +
                         r"-proc\d{5}-of-(\d{5})\.index\.json$")
        names: List[str] = []
        # relative/flat prefixes have no dir component: local = cwd,
        # flat-key filesystems (ram://) list the root
        for cand in ([d] if d else [".", ""]):
            try:
                names = fs.listdir(cand)
            except (FileNotFoundError, OSError):
                names = []
            if names:
                break
        matches = sorted(fn for fn in names if pat.match(fn))
        if not matches:
            raise FileNotFoundError(f"no multihost bundles under {prefix}")
        # an incomplete listing must be a hard error, not a silent partial
        # restore of a subset of the processes' rows
        counts = {int(pat.match(fn).group(1)) for fn in matches}
        if len(counts) != 1:
            raise IOError(
                f"multihost bundles under {prefix} disagree on process "
                f"count: {sorted(counts)} — mixed/partial save?")
        want = counts.pop()
        if len(matches) != want:
            raise IOError(
                f"multihost checkpoint under {prefix} is incomplete: found "
                f"{len(matches)} of {want} process bundles (listing "
                "truncated or save still in flight)")
        idx = [scheme + (d + "/" if d else "") + fn for fn in matches]
        self._readers = [bundle.BundleReader(fn[:-len(".index.json")])
                         for fn in idx]
        self._where = {}
        for r in self._readers:
            for k in r.keys():
                self._where.setdefault(k, r)

    def keys(self) -> List[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def shape(self, name: str):
        return self._where[name].shape(name)

    def dtype(self, name: str):
        return self._where[name].dtype(name)

    def num_elements(self, name: str) -> int:
        return self._where[name].num_elements(name)

    def lookup(self, name: str, verify: bool = True) -> np.ndarray:
        return self._where[name].lookup(name, verify=verify)

    def lookup_slice(self, name: str, start_row: int, num_rows: int):
        return self._where[name].lookup_slice(name, start_row, num_rows)

    def stream(self, name: str, chunk_rows: int, verify: bool = True):
        return self._where[name].stream(name, chunk_rows, verify=verify)


def save_multihost(prefix: str, tables: Dict[str, TableOrShards],
                   dense=None, *, process_id: int,
                   num_processes: int, **kw) -> Dict[str, TableOrShards]:
    """Per-process save: ``tables[name]`` holds this process's CONSECUTIVE
    local shards; global part index = ``process_id * len(local) + i``.
    Dense state is written by process 0 only. Call on every process (no
    ordering requirement, no collectives); restore with
    ``restore(UnionReader(prefix), ...)`` or :func:`restore_multihost`."""
    p = _proc_prefix(prefix, process_id, num_processes)
    out: Dict[str, TableOrShards] = {}
    with bundle.BundleWriter(p) as w:
        for name, t in tables.items():
            shards = _shards(t)
            n_local = len(shards)
            n_total = n_local * num_processes
            new = []
            for i, s in enumerate(shards):
                g = process_id * n_local + i
                new.append(save_table(w, shard_name(name, g, n_total), s,
                                      **kw))
            out[name] = new if isinstance(t, (list, tuple)) else new[0]
            if process_id == 0:
                w.add(name + "-num_shards", np.array([n_total], np.int32))
        if dense is not None and process_id == 0:
            for key, leaf in _dense_leaves(dense).items():
                w.add(key, _host(leaf))
    return out


def restore_multihost(prefix: str, tables: Dict[str, TableOrShards],
                      dense=None, *, delta: bool = False):
    """Restore a :func:`save_multihost` checkpoint — any process count, any
    target shard count."""
    return restore(UnionReader(prefix), tables, dense, delta=delta)
