"""Export KvTables as TFPlus checkpoints (TensorFlow TensorBundles).

Counterpart of ``tfplus_tpu/checkpoint/tf_export.py``, with its function,
arguments and tensor order, written by the port's own bundle writer
(:mod:`.tf_bundle`, the bytes ``SaveV2`` writes) instead of TensorFlow.
It writes the reference's logical tensors, ``<var>-keys``, ``-values``,
``-init_table``, ``-blacklist``, ``-freq_keys``, ``-freq_values``
(kv_variable_ops.py:1458-1459; which of them by ``first_n``), as a
TensorBundle that TFPlus-based systems read directly:
``tf.train.load_checkpoint``, the reference's restore path, and ranking
services that address KV checkpoint tensors by name
(common/ranking_utils.py ``embedding_var_keys/values``).

Sharded tables write ``name/part_i-*`` (variable_scope.py:383-430), so a
reference deployment with the same shard count restores them natively.
``freq_use_uint32=True`` writes the packed ``freq|day<<16`` word (SaveV3's
contract, ops/kv_variable_ops.cc:708-733); False writes the legacy uint16
frequency view. Each shard is exported (through the row-gather kernel) and
written in turn, so only one shard's arrays are on the host at a time.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..kv import table as kvt
from .saver import (FIRST_N_BLACKLIST, FIRST_N_INFERENCE, FIRST_N_TRAIN,
                    TableOrShards, _shards, shard_name)
from .tf_bundle import TFBundleWriter


def _keys_out(u64: np.ndarray, key_dtype) -> np.ndarray:
    if np.dtype(key_dtype) == np.uint64:
        return u64.astype(np.uint64)
    # int64 checkpoints: the same 64-bit patterns, signed view (ModKeyImpl
    # routing is over the unsigned view either way, utility.h:96-112)
    return u64.view(np.int64)


def _tensors(tables: Dict[str, TableOrShards], first_n: int, key_dtype,
             freq_use_uint32: bool, enable_cutoff: bool, cutoff_value: float,
             dense: Optional[Dict[str, np.ndarray]],
             as_of_unix_day: Optional[int]
             ) -> Iterator[Tuple[str, np.ndarray]]:
    """``(name, array)`` in the JAX package's ``SaveV2`` order, one shard
    exported at a time."""
    for name, t in tables.items():
        shards = _shards(t)
        ns = len(shards)
        for i, s in enumerate(shards):
            base = shard_name(name, i, ns)
            ex = kvt.export_arrays(s, enable_cutoff=enable_cutoff,
                                   cutoff_value=cutoff_value,
                                   clear_deltalist=False,
                                   as_of_unix_day=as_of_unix_day)
            keys = _keys_out(np.asarray(ex["keys"], np.uint64), key_dtype)
            yield base + "-keys", keys
            yield base + "-values", ex["values"]
            if first_n >= FIRST_N_INFERENCE:
                yield base + "-init_table", ex["init_table"]
            if first_n >= FIRST_N_BLACKLIST:
                yield base + "-blacklist", _keys_out(
                    np.asarray(ex["blacklist"], np.uint64), key_dtype)
            if first_n >= FIRST_N_TRAIN:
                yield base + "-freq_keys", keys
                if freq_use_uint32:
                    yield base + "-freq_values", np.asarray(ex["meta"],
                                                            np.uint32)
                else:
                    yield base + "-freq_values", np.asarray(
                        ex["freq_values"], np.uint16)
    if dense:
        for name, arr in dense.items():
            yield name, arr


def export_checkpoint(prefix: str, tables: Dict[str, TableOrShards], *,
                      first_n: int = FIRST_N_TRAIN,
                      key_dtype=np.int64,
                      freq_use_uint32: bool = False,
                      enable_cutoff: bool = False,
                      cutoff_value: float = 1e-20,
                      dense: Optional[Dict[str, np.ndarray]] = None,
                      as_of_unix_day: Optional[int] = None) -> str:
    """Write ``tables`` (KvTable or per-shard list) as a TF TensorBundle at
    ``prefix`` (a local path); returns the prefix. The tables are read, not
    changed. Optimizer slot columns are NOT written (the reference stores
    slots as separate optimizer-owned KvVariables; export those explicitly
    as their own entries if a reference training job must resume;
    inference and serving need first_n=3 only). ``dense`` values may be
    numpy arrays or tensors."""
    with TFBundleWriter(prefix) as w:
        for name, arr in _tensors(tables, first_n, key_dtype,
                                  freq_use_uint32, enable_cutoff,
                                  cutoff_value, dense, as_of_unix_day):
            w.add(name, arr)
    return prefix
