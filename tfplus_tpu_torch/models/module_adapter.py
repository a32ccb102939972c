"""Run any ``torch.nn.Module`` dense tower on KV embeddings.

Counterpart of ``tfplus_tpu/models/flax_adapter.py`` (``FlaxSparseModel``):
:class:`ModuleSparseModel` adapts a module to the :class:`SparseModel`
protocol, so the whole harness (``init_state``, ``make_train_step``, the
multi-table step, checkpoints) applies to it unchanged.

The module's ``forward(embeddings, features)`` takes a dict of ``[B, dim]``
tensors keyed by table name and the dense-feature tensor (or ``None``) and
returns predictions or logits. Its parameters are the state's ``dense`` and
are updated by the dense optimizer.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from .common import SparseModel
from .dcn import optax_sigmoid_ce


class ModuleSparseModel(SparseModel):
    """Adapt an ``nn.Module`` to the SparseModel training harness.

    Args:
      module: ``module(generator, device) -> nn.Module``, a factory that
        builds the tower on ``device`` with its initial weights drawn from
        ``generator`` (a module class whose constructor takes those two
        arguments is one).
      table_specs: name -> dict(dim=..., capacity=..., **kv.create kwargs).
      feature_dim: width of the dense-feature input (None → features=None).
      loss_fn: ``(preds, labels) -> scalar``; defaults to mean sigmoid CE.
      id_alias: optional table-name -> id-stream-name aliasing (several
        tables reading one id column, e.g. dim-1 linear terms).
    """

    def __init__(self, module: Callable[[torch.Generator, torch.device],
                                        nn.Module],
                 table_specs: Dict[str, dict], *,
                 feature_dim: Optional[int] = None,
                 loss_fn: Optional[Callable] = None,
                 id_alias: Optional[Dict[str, str]] = None):
        self.module = module
        self.table_specs = dict(table_specs)
        self.feature_dim = feature_dim
        self._loss_fn = loss_fn
        if id_alias:
            self.id_alias = dict(id_alias)

    def init_dense(self, generator: torch.Generator, device) -> nn.Module:
        return self.module(generator, torch.device(device))

    def apply(self, dense: nn.Module, embeddings: Dict[str, torch.Tensor],
              features):
        return dense(embeddings, features)

    def loss(self, preds, labels):
        if self._loss_fn is not None:
            return self._loss_fn(preds, labels)
        return torch.mean(optax_sigmoid_ce(preds, labels.to(preds.dtype)))
