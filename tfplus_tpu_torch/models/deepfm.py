"""DeepFM and Wide&Deep — CTR models with a linear term over dim-1 tables.

Counterpart of ``tfplus_tpu/models/deepfm.py``. Both models give each field
``C{i}`` an embedding table and a dim-1 table ``C{i}_w`` read with the same
ids (``id_alias``), whose rows are the field's linear weights.

DeepFM (Guo et al., IJCAI'17): the FM second-order term ``0.5·((Σv)² −
Σv²)`` over the fields' embeddings, the first-order sum of the linear
weights, a deep tower over the embeddings and the numeric features, and a
bias, summed into one logit.

Wide&Deep (Cheng et al., 2016): the linear weights plus a dense layer over
the numeric features (wide), and a deep tower over the embeddings and the
numeric features (deep), summed into one logit.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..nn import layers as L
from .common import SparseModel
from .dcn import optax_sigmoid_ce


def _field_specs(model, num_fields: int, embedding_dim: int, capacity: int):
    model.table_specs = {}
    for i in range(num_fields):
        model.table_specs[f"C{i+1}"] = dict(dim=embedding_dim,
                                            capacity=capacity)
        model.table_specs[f"C{i+1}_w"] = dict(dim=1, capacity=capacity)
    model.id_alias = {f"C{i+1}_w": f"C{i+1}" for i in range(num_fields)}


def _linear_term(embeddings, num_fields: int) -> torch.Tensor:
    """Σ over fields of the dim-1 linear weights, [B]."""
    return sum(embeddings[f"C{i+1}_w"][:, 0] for i in range(num_fields))


class DeepFMDense(nn.Module):
    """DeepFM's dense parts; names follow the JAX parameter pytree (``dnn``,
    ``dnn_logits``, ``bias``)."""

    def __init__(self, input_dim: int, dnn_hidden: Sequence[int],
                 generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dnn = L.MLP(input_dim, list(dnn_hidden),
                         final_activation=torch.relu, **kw)
        self.dnn_logits = L.Dense(dnn_hidden[-1], 1, **kw)
        self.bias = nn.Parameter(torch.zeros(1, device=device))


class DeepFM(SparseModel):
    def __init__(self, num_fields: int = 26, embedding_dim: int = 16,
                 num_numeric: int = 13, dnn_hidden=(256, 128),
                 capacity: int = 1 << 14):
        self.num_fields = num_fields
        self.embedding_dim = embedding_dim
        self.num_numeric = num_numeric
        self.dnn_hidden = tuple(dnn_hidden)
        _field_specs(self, num_fields, embedding_dim, capacity)
        self.input_dim = num_fields * embedding_dim + num_numeric

    def init_dense(self, generator: torch.Generator, device) -> DeepFMDense:
        return DeepFMDense(self.input_dim, self.dnn_hidden, generator, device)

    def apply(self, dense: DeepFMDense, embeddings: Dict[str, torch.Tensor],
              features):
        v = torch.stack([embeddings[f"C{i+1}"]
                         for i in range(self.num_fields)], dim=1)  # [B, F, D]
        s = v.sum(dim=1)
        fm = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)       # [B]
        first = _linear_term(embeddings, self.num_fields)
        h = dense.dnn(torch.cat([v.reshape(v.shape[0], -1), features],
                                dim=-1))
        deep = dense.dnn_logits(h)[..., 0]
        return fm + first + deep + dense.bias[0]

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))


class WideDeepDense(nn.Module):
    """Wide&Deep's dense parts; names follow the JAX parameter pytree
    (``dnn``, ``dnn_logits``, ``wide_numeric``)."""

    def __init__(self, input_dim: int, dnn_hidden: Sequence[int],
                 num_numeric: int, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dnn = L.MLP(input_dim, list(dnn_hidden),
                         final_activation=torch.relu, **kw)
        self.dnn_logits = L.Dense(dnn_hidden[-1], 1, **kw)
        self.wide_numeric = L.Dense(num_numeric, 1, **kw)


class WideDeep(SparseModel):
    def __init__(self, num_fields: int = 26, embedding_dim: int = 16,
                 num_numeric: int = 13, dnn_hidden=(256, 128),
                 capacity: int = 1 << 14):
        self.num_fields = num_fields
        self.embedding_dim = embedding_dim
        self.num_numeric = num_numeric
        self.dnn_hidden = tuple(dnn_hidden)
        _field_specs(self, num_fields, embedding_dim, capacity)
        self.input_dim = num_fields * embedding_dim + num_numeric

    def init_dense(self, generator: torch.Generator, device) -> WideDeepDense:
        return WideDeepDense(self.input_dim, self.dnn_hidden,
                             self.num_numeric, generator, device)

    def apply(self, dense: WideDeepDense,
              embeddings: Dict[str, torch.Tensor], features):
        wide = _linear_term(embeddings, self.num_fields) \
            + dense.wide_numeric(features)[..., 0]
        h = dense.dnn(torch.cat(
            [embeddings[f"C{i+1}"] for i in range(self.num_fields)]
            + [features], dim=-1))
        return wide + dense.dnn_logits(h)[..., 0]

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))
