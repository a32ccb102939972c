"""NCF — neural collaborative filtering on KV embeddings.

Counterpart of ``tfplus_tpu/models/ncf.py``: user and movie embeddings
(dim 32) concatenated → Dense(256, relu) → Dense(64, relu) → Dense(1), and a
mean squared error against the rating.
"""
from __future__ import annotations

import torch

from ..nn import layers as L
from .common import SparseModel


class NCF(SparseModel):
    def __init__(self, embedding_dim: int = 32, hidden=(256, 64),
                 capacity: int = 1 << 13):
        self.embedding_dim = embedding_dim
        self.hidden = tuple(hidden)
        self.table_specs = {
            "user": dict(dim=embedding_dim, capacity=capacity),
            "movie": dict(dim=embedding_dim, capacity=capacity),
        }

    def init_dense(self, generator: torch.Generator, device) -> L.MLP:
        """The tower is one MLP, so its state-dict names (``0.w``, ...)
        are the JAX parameter list's paths."""
        return L.MLP(2 * self.embedding_dim, list(self.hidden) + [1],
                     scale=0.1, generator=generator, device=device)

    def apply(self, dense: L.MLP, embeddings, features):
        x = torch.cat([embeddings["user"], embeddings["movie"]], dim=-1)
        return dense(x)[..., 0]

    def loss(self, preds, labels):
        return torch.mean((preds - labels) ** 2)
