"""Import TFPlus checkpoints (TensorFlow TensorBundles) into KvTables.

Counterpart of ``tfplus_tpu/checkpoint/tf_import.py``, with its functions,
arguments and semantics, on the port's own bundle reader
(:mod:`.tf_bundle`) instead of TensorFlow: no TensorFlow is needed, on the
host or on the card.

The reference persists every KvVariable as six logical tensors in a
standard TF TensorBundle: ``<var>-keys``, ``-values``, ``-init_table``,
``-blacklist``, ``-freq_keys``, ``-freq_values`` (naming:
kv_variable_ops.py:1458-1459). This module discovers the KV variables in a
TFPlus checkpoint, regroups their ``name/part_i`` shards and rebuilds them
as KvTables with the reference's ImportValues semantics
(dynamic_restore.hpp:156-262):

  * keys and values upserted into a cleared table,
  * init_table replaces the init pool when non-empty,
  * blacklisted keys read as zeros,
  * frequencies update EXISTING rows only (freq keys absent from the key
    set are dropped), from the uint16 frequency view or SaveV3's packed
    uint32 ``freq|day<<16`` word (``freq_use_uint32``).

Elastic restore applies: rows route to the requested shard count by
``key % n``, as a native restore routes them. Fresh tables are made on
``device`` (``"cuda"`` unless the caller asks for another); templates keep
their own.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..kv import hashing
from ..kv import table as kvt
from .tf_bundle import TFBundleReader

_PART_RE = re.compile(r"^(.*)/part_(\d+)$")

TableOrShards = Union[kvt.KvTable, Sequence[kvt.KvTable]]


def list_kv_variables(prefix: str) -> Dict[str, dict]:
    """Discover KvVariables in a TFPlus checkpoint.

    A KvVariable shard is any tensor pair ``X-keys`` / ``X-values``;
    ``name/part_i`` shards regroup under their generic name (reference
    get_generic_name, common/util.py:107-121). Returns
    ``{name: {"num_shards", "shard_prefixes", "dim", "rows",
    "has_blacklist", "has_freq", "freq_dtype"}}``.
    """
    return _kv_infos(TFBundleReader(prefix))


def _kv_infos(reader: TFBundleReader) -> Dict[str, dict]:
    shapes = reader.get_variable_to_shape_map()
    dtypes = reader.get_variable_to_dtype_map()
    out: Dict[str, dict] = {}
    for tname in shapes:
        if not tname.endswith("-keys"):
            continue
        base = tname[:-len("-keys")]
        if base + "-values" not in shapes:
            continue
        m = _PART_RE.match(base)
        name, idx = (m.group(1), int(m.group(2))) if m else (base, 0)
        info = out.setdefault(name, {
            "num_shards": 0, "shard_prefixes": {}, "dim": None, "rows": 0,
            "has_blacklist": False, "has_freq": False, "freq_dtype": None})
        info["shard_prefixes"][idx] = base
        info["num_shards"] = max(info["num_shards"], idx + 1)
        vshape = shapes[base + "-values"]
        if len(vshape) == 2:
            info["dim"] = vshape[1]
        info["rows"] += int(vshape[0]) if vshape else 0
        if base + "-blacklist" in shapes:
            info["has_blacklist"] = True
        if base + "-freq_values" in shapes:
            info["has_freq"] = True
            info["freq_dtype"] = np.dtype(dtypes[base + "-freq_values"])
    return out


def _keys_u64(arr: np.ndarray) -> np.ndarray:
    """Checkpoint keys (int32/int64/uint64) → the uint64 id space, by bit
    pattern: negative ids keep their bits (ModKeyImpl's routing is over the
    unsigned view, utility.h:96-112)."""
    if arr.dtype == np.uint64:
        return arr
    return arr.astype(np.int64).view(np.uint64) if arr.dtype != np.int64 \
        else arr.view(np.uint64)


def _collect_var(reader: TFBundleReader, info: dict) -> dict:
    """Concatenate every shard's tensors for one KvVariable; a shard's
    missing optional tensor is skipped."""
    keys, values, freq_k, freq_v, black = [], [], [], [], []
    init_table = None
    for i in sorted(info["shard_prefixes"]):
        base = info["shard_prefixes"][i]
        k = _keys_u64(reader.get_tensor(base + "-keys"))
        v = reader.get_tensor(base + "-values")
        keys.append(k)
        values.append(v.reshape(len(k), -1))
        if info["has_blacklist"] and reader.has_tensor(base + "-blacklist"):
            black.append(_keys_u64(
                reader.get_tensor(base + "-blacklist").reshape(-1)))
        if (info["has_freq"] and reader.has_tensor(base + "-freq_keys")
                and reader.has_tensor(base + "-freq_values")):
            freq_k.append(_keys_u64(
                reader.get_tensor(base + "-freq_keys").reshape(-1)))
            freq_v.append(reader.get_tensor(base + "-freq_values")
                          .reshape(-1))
        if init_table is None and reader.has_tensor(base + "-init_table"):
            it = reader.get_tensor(base + "-init_table")
            if it.size:
                init_table = it
    dim = values[0].shape[1] if values and values[0].size else info["dim"]
    return {
        "keys": np.concatenate(keys) if keys else np.zeros((0,), np.uint64),
        "values": (np.concatenate(values) if values
                   else np.zeros((0, dim or 0), np.float32)),
        "blacklist": (np.concatenate(black) if black
                      else np.zeros((0,), np.uint64)),
        "freq_keys": (np.concatenate(freq_k) if freq_k
                      else np.zeros((0,), np.uint64)),
        "freq_values": (np.concatenate(freq_v) if freq_v
                        else np.zeros((0,), np.uint16)),
        "init_table": init_table,
    }


def _align_freq(keys: np.ndarray, freq_keys: np.ndarray,
                freq_values: np.ndarray) -> Optional[np.ndarray]:
    """Per-key frequency aligned to ``keys``: frequencies apply to existing
    rows only; freq keys outside the key set are dropped
    (dynamic_restore.hpp:219-249). Array passes over the sorted freq keys,
    for variables of tens of millions of rows."""
    if not len(freq_keys):
        return None
    order = np.argsort(freq_keys)
    sk = freq_keys[order]
    pos = np.clip(np.searchsorted(sk, keys), 0, len(sk) - 1)
    hit = sk[pos] == keys
    out = np.zeros((len(keys),), freq_values.dtype)
    out[hit] = freq_values[order[pos[hit]]]
    return out


def import_kv_variable(prefix: str, name: str, *,
                       templates: Optional[Sequence[kvt.KvTable]] = None,
                       num_shards: int = 1,
                       capacity: int = 1 << 14,
                       value_dtype=None,
                       device="cuda") -> List[kvt.KvTable]:
    """Rebuild one KvVariable from a TFPlus checkpoint as ``num_shards``
    KvTables (rows routed by ``key % num_shards``, the reference's
    partition function, embedding_ops.py:121-127).

    ``templates`` (optional) supplies per-shard table templates (capacity,
    dtype, slot layout, device); otherwise fresh tables of ``capacity`` are
    made on ``device`` and grown as needed.
    """
    reader = TFBundleReader(prefix)
    infos = _kv_infos(reader)
    if name not in infos:
        raise KeyError(
            f"no KvVariable '{name}' in {prefix}; found: {sorted(infos)}")
    info = infos[name]
    data = _collect_var(reader, info)
    dim = data["values"].shape[1] if data["values"].size else info["dim"]
    if templates is not None:
        num_shards = len(templates)

    keys = data["keys"]
    assign = (keys % np.uint64(num_shards)).astype(np.int64) \
        if num_shards > 1 else np.zeros(len(keys), np.int64)
    freq_aligned = _align_freq(keys, data["freq_keys"], data["freq_values"])

    out: List[kvt.KvTable] = []
    for s in range(num_shards):
        sel = assign == s
        if templates is not None:
            template = templates[s]
        else:
            template = kvt.create(
                dim, capacity, value_dtype=value_dtype or torch.float32,
                name=f"{name}/part_{s}" if num_shards > 1 else name,
                device=device)
        sub = {"keys": keys[sel], "values": data["values"][sel]}
        if data["init_table"] is not None:
            sub["init_table"] = data["init_table"]
        if data["blacklist"].size:
            sub["blacklist"] = data["blacklist"]
        if freq_aligned is not None:
            fv = freq_aligned[sel]
            if fv.dtype == np.uint32:
                # SaveV3 freq_use_uint32: the packed freq|day<<16 word
                sub["meta"] = fv
            else:
                sub["freq_values"] = fv.astype(np.uint16)
        out.append(kvt.import_arrays(template, sub, clear=True))
    return out


def import_checkpoint(prefix: str, tables: Dict[str, TableOrShards]
                      ) -> Dict[str, TableOrShards]:
    """Restore every requested table from a TFPlus checkpoint.

    ``tables`` maps checkpoint variable names (generic, without
    ``/part_i``) to template tables — a single KvTable or a list of
    per-shard templates, as for :func:`saver.restore`. The checkpoint's own
    shard count is irrelevant (elastic re-mod).
    """
    out: Dict[str, TableOrShards] = {}
    for name, t in tables.items():
        want = list(t) if isinstance(t, (list, tuple)) else [t]
        shards = import_kv_variable(prefix, name, templates=want)
        out[name] = shards if isinstance(t, (list, tuple)) else shards[0]
    return out


def attach_slot_rows(table: kvt.KvTable, prefix: str, slot_var: str,
                     slot_name: str) -> kvt.KvTable:
    """Copy a TFPlus optimizer-slot KvVariable's rows into ``table``'s
    co-located slot columns (in place, or in a new table when the slot
    columns had to be added).

    The reference stores optimizer slots as separate KvVariables sharing
    the primary's keys (slot_creator hook, variable_scope.py:1027-1093;
    concat slots like AdamV4's ``m_v_linear`` are one variable of width
    k·dim). Rows whose key is missing from ``table`` are dropped.
    """
    reader = TFBundleReader(prefix)
    infos = _kv_infos(reader)
    if slot_var not in infos:
        raise KeyError(f"no slot variable '{slot_var}' in {prefix}")
    data = _collect_var(reader, infos[slot_var])
    if not data["keys"].size:
        return table
    k = data["values"].shape[1] // table.dim
    if slot_name not in table.config.slot_columns():
        table = kvt.ensure_slots(table, {slot_name: k})
    q = hashing.encode_ids_np_to_device(data["keys"], table.device)
    fr = kvt.find(table, q)
    idx = torch.where(fr.found, fr.slot, -1)
    return kvt.set_slot_rows(table, slot_name, idx,
                             torch.from_numpy(np.ascontiguousarray(
                                 data["values"])))


def read_dense(prefix: str, name: str) -> np.ndarray:
    """Read any non-KV tensor (dense variable) from the checkpoint."""
    return TFBundleReader(prefix).get_tensor(name)
