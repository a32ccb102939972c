"""Carry tables, dense weights and whole training states from the JAX
package into the port.

The functions take plain numpy data (what ``jax.device_get`` returns), so
the port never sees a JAX array.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .kv.table import KvConfig, KvTable
from .utils import device as _dev

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}

TABLE_FIELDS = ("header", "payload", "init_pool", "deleted_keys",
                "deleted_count", "deleted_overflow", "deleted_seen_train",
                "deleted_seen_pred")


def _tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 → same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def table_from_numpy(arrays: Dict[str, np.ndarray], config: KvConfig,
                     device="cuda") -> KvTable:
    """A port table whose arrays are exactly ``arrays`` (the JAX table's
    fields ``header``, ``payload``, ``init_pool`` and the deletion log)."""
    dev = _dev.resolve(device)
    fields = {k: _tensor(arrays[k], dev) for k in TABLE_FIELDS}
    if fields["payload"].dtype != config.value_dtype:
        raise TypeError(f"payload dtype {fields['payload'].dtype} != config "
                        f"value_dtype {config.value_dtype}")
    if fields["payload"].shape[1] != config.payload_width:
        raise ValueError(f"payload width {fields['payload'].shape[1]} != "
                         f"config payload_width {config.payload_width}")
    return KvTable(config=config, **fields)


def sharded_from_numpy(stacked_arrays: Dict[str, np.ndarray],
                       config: KvConfig, rank: int, device="cuda") -> KvTable:
    """Rank ``rank``'s shard of a JAX sharded table (the JAX package's
    stacked layout, every field with a leading shard axis, as numpy
    arrays): the port table of shard ``rank`` through
    :func:`table_from_numpy`, so that every rank starts from JAX's state."""
    return table_from_numpy({k: np.asarray(stacked_arrays[k])[rank]
                             for k in TABLE_FIELDS}, config, device)


def sharded_2d_from_numpy(stacked_arrays: Dict[str, np.ndarray],
                          config: KvConfig, r: int, c: int,
                          device="cuda") -> KvTable:
    """Shard (r, c) of a JAX 2D-sharded table (leading [R, C] axes)."""
    return table_from_numpy({k: np.asarray(stacked_arrays[k])[r, c]
                             for k in TABLE_FIELDS}, config, device)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def dense_from_numpy(model: nn.Module, params) -> nn.Module:
    """Load a JAX dense-parameter pytree (nested dicts and lists of numpy
    arrays) into ``model`` in place; the pytree's paths are the module's
    state-dict names (``dnn.0.w``, ``cross_logits.b``, ...). That covers
    every model of the port: a leaf at the top (DeepFM's ``bias``, an
    ``nn.Parameter``), a pytree that is a list (NCF's tower, an ``MLP``:
    ``0.w``) and nested towers (DLRM's ``bottom.0.w``). Every parameter
    must be matched exactly once."""
    state = model.state_dict()
    flat = _flatten(params)
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, "
                       f"unexpected {extra}")
    model.load_state_dict({k: _tensor(v, state[k].device).to(state[k].dtype)
                           for k, v in flat.items()})
    return model


def config_from_numpy(cfg) -> KvConfig:
    """The port's :class:`KvConfig` for a JAX table's config (any object
    with its fields; ``value_dtype`` a numpy or ml_dtypes dtype)."""
    return KvConfig(dim=cfg.dim, enter_threshold=cfg.enter_threshold,
                    max_probes=cfg.max_probes,
                    value_dtype=_TORCH_DTYPES[np.dtype(cfg.value_dtype).name],
                    name=cfg.name, slot_layout=tuple(cfg.slot_layout),
                    support_prediction_delta=cfg.support_prediction_delta)


def state_from_numpy(state, model, dense_tx=None, device="cuda"):
    """The port's ``TrainState`` from a JAX ``TrainState`` fetched to the
    host (``jax.device_get(state)``), per-table or multi-table alike: every
    table through :func:`table_from_numpy` under its own name (a
    multi-table state's ``__group_<dim>`` tables included), the dense
    weights loaded into ``model.init_dense(...)`` by
    :func:`dense_from_numpy`, the step count carried over. The dense
    optimizer is new: ``dense_tx(params)`` (as in ``models.init_state``),
    or None."""
    from .models.common import TrainState
    dev = _dev.resolve(device)
    tables = {}
    for name, t in state.tables.items():
        arrays = {f: np.asarray(getattr(t, f)) for f in TABLE_FIELDS}
        tables[name] = table_from_numpy(arrays, config_from_numpy(t.config),
                                        dev)
    dense = model.init_dense(torch.Generator().manual_seed(0), dev)
    dense_from_numpy(dense, state.dense)
    return TrainState(tables=tables, dense=dense,
                      opt_state=(None if dense_tx is None
                                 else dense_tx(dense.parameters())),
                      step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=dev))
