"""Carry tables and dense weights from the JAX package into the port.

Both functions take plain numpy data (what ``jax.device_get`` returns), so
the port never sees a JAX object.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .kv.table import KvConfig, KvTable
from .utils import device as _dev

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
