"""DCN — Deep & Cross Network for CTR prediction on KV embeddings.

Counterpart of ``tfplus_tpu/models/dcn.py``: 26 hashed categorical features,
each with its own KV table (reference dims below), plus 13 numeric features;
a deep tower (default 1024-512-256, relu) and a 2-layer cross network each
produce a logit from the shared input, and the logits sum into a
sigmoid-cross-entropy loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..nn import layers as L
from .common import SparseModel

NUM_NUMERIC = 13
NUM_CATEGORICAL = 26

# Reference per-column embedding dims: 18 of 64 and 8 of 128
REFERENCE_EMBEDDING_DIMENSIONS = (
    64, 64, 128, 128, 64, 64, 64, 64, 64, 128, 64, 128, 64,
    64, 64, 128, 64, 64, 64, 64, 128, 64, 64, 128, 64, 128)


class DCNDense(nn.Module):
    """The DCN's dense towers. Submodule names follow the JAX parameter
    pytree (``dnn``, ``dnn_logits``, ``cross``, ``cross_logits``)."""

    def __init__(self, input_dim: int, dnn_hidden: Sequence[int],
                 cross_layers: int, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dnn = L.MLP(input_dim, list(dnn_hidden),
                         final_activation=torch.relu, **kw)
        self.dnn_logits = L.Dense(dnn_hidden[-1], 1, **kw)
        self.cross = L.CrossNet(input_dim, cross_layers, **kw)
        self.cross_logits = L.Dense(input_dim, 1, **kw)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        logits = self.dnn_logits(self.dnn(net)) \
            + self.cross_logits(self.cross(net))
        return logits[..., 0]


class DCN(SparseModel):
    def __init__(self,
                 embedding_dims: Optional[Sequence[int]] = None,
                 num_numeric: int = NUM_NUMERIC,
                 dnn_hidden=(1024, 512, 256),
                 cross_layers: int = 2,
                 capacity: int = 1 << 14,
                 uniform_dim: Optional[int] = None):
        """``uniform_dim`` overrides per-column dims (handy for small tests);
        default dims follow the reference."""
        if embedding_dims is None:
            embedding_dims = ([uniform_dim] * NUM_CATEGORICAL if uniform_dim
                              else REFERENCE_EMBEDDING_DIMENSIONS)
        self.embedding_dims = tuple(embedding_dims)
        self.num_numeric = num_numeric
        self.dnn_hidden = tuple(dnn_hidden)
        self.cross_layers = cross_layers
        self.table_specs = {
            f"C{i+1}": dict(dim=d, capacity=capacity)
            for i, d in enumerate(self.embedding_dims)
        }
        self.input_dim = sum(self.embedding_dims) + num_numeric

    def init_dense(self, generator: torch.Generator, device) -> DCNDense:
        return DCNDense(self.input_dim, self.dnn_hidden, self.cross_layers,
                        generator, device)

    def apply(self, dense: DCNDense, embeddings: Dict[str, torch.Tensor],
              features):
        cats = [embeddings[f"C{i+1}"] for i in range(len(self.embedding_dims))]
        parts = cats + ([features] if self.num_numeric else [])
        return dense(torch.cat(parts, dim=-1))

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))


def optax_sigmoid_ce(logits, labels):
    """Numerically-stable sigmoid cross entropy."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))
