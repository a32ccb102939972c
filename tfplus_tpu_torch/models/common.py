"""Sparse-model harness: tables, state and the step.

Counterpart of ``tfplus_tpu/models/common.py``. KV tables are explicit state
carried in :class:`TrainState`; the dense towers are an ``nn.Module``. This
slice ports the serving step (``train=False``): lookups, the model and the
loss. Training (sparse optimizers, dense optimizer, backward) comes with the
port's training slice.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from .. import embedding as emb
from ..kv import table as kvt
from ..utils import device as _dev

_TRAINING_SLICE = ("training (sparse optimizers, dense optimizer, backward) "
                   "is not ported yet; it comes with the port's training "
                   "slice")


class SparseModel:
    """Protocol: subclass and define table_specs / init_dense / apply / loss."""
    #: name -> dict(dim=..., capacity=..., **kv.create kwargs)
    table_specs: Dict[str, dict] = {}

    def init_dense(self, generator: torch.Generator, device) -> nn.Module:
        raise NotImplementedError

    def apply(self, dense: nn.Module, embeddings: Dict[str, torch.Tensor],
              features):
        """embeddings[name] is [B, D_name]; returns logits/predictions."""
        raise NotImplementedError

    def loss(self, preds, labels):
        raise NotImplementedError

    def init_tables(self, sparse_opt=None, seed: int = 0,
                    device="cuda") -> Dict[str, kvt.KvTable]:
        if sparse_opt is not None:
            raise NotImplementedError(_TRAINING_SLICE)
        tables = {}
        for i, (name, spec) in enumerate(sorted(self.table_specs.items())):
            spec = dict(spec)
            spec.setdefault("name", name)
            tables[name] = kvt.create(seed=seed + i, device=device, **spec)
        return tables


class TrainState(NamedTuple):
    tables: Dict[str, kvt.KvTable]
    dense: nn.Module
    opt_state: object
    step: torch.Tensor


def init_state(model: SparseModel, sparse_opt=None, dense_tx=None,
               seed: int = 0, device="cuda") -> TrainState:
    """Tables and dense towers on ``device``. ``sparse_opt`` / ``dense_tx``
    must be None until the training slice is ported."""
    if sparse_opt is not None or dense_tx is not None:
        raise NotImplementedError(_TRAINING_SLICE)
    dev = _dev.resolve(device)
    dense = model.init_dense(torch.Generator().manual_seed(seed), dev)
    return TrainState(tables=model.init_tables(None, seed, device=dev),
                      dense=dense, opt_state=None,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _features(features, device):
    if features is None:
        return None
    if isinstance(features, Mapping):
        return {k: _features(v, device) for k, v in features.items()}
    return torch.as_tensor(features, dtype=torch.float32, device=device)


def make_train_step(model: SparseModel, sparse_opt=None, dense_tx=None, *,
                    sparse_lr: Optional[float] = None,
                    train: bool = True) -> Callable:
    """Build ``step(state, batch) -> (state, loss, preds)``.

    ``batch`` = dict with per-table id arrays under ``batch["ids"][name]``
    (rank-1), optional dense ``batch["features"]`` and ``batch["labels"]``.
    Features are an array, which becomes one float32 tensor on the state's
    device, or a dict of arrays (BST/DIN: ``{"numeric", "mask"}``), which
    becomes a dict of such tensors.
    Only ``train=False`` is ported: lookups that never insert, the model and
    the loss; the state comes back unchanged.
    """
    if train:
        raise NotImplementedError(_TRAINING_SLICE)
    # the JAX reference runs its float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # models may alias several tables to one id stream
    alias = getattr(model, "id_alias", {})

    def step(state: TrainState, batch):
        with torch.no_grad():
            embs = {}
            for name in sorted(state.tables):
                table = state.tables[name]
                look, _ = emb.lookup_unique(
                    table, batch["ids"][alias.get(name, name)], train=False)
                embs[name] = emb.gather(look)
            dev = state.step.device
            features = _features(batch.get("features"), dev)
            preds = model.apply(state.dense, embs, features)
            labels = torch.as_tensor(batch["labels"], device=dev)
            loss = model.loss(preds, labels)
        return state, loss, preds

    return step
