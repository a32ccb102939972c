"""DLRM — multi-table embeddings with a pairwise dot interaction.

Counterpart of ``tfplus_tpu/models/dlrm.py``: a bottom MLP projects the
numeric features to the embedding dim (relu after its last layer too); the
bottom output and the ``T0..T{n-1}`` embeddings form ``F = n + 1`` feature
vectors whose ``F(F-1)/2`` pairwise dot products (one ``bmm``, then the
strict upper triangle in ``triu_indices``' row-major order, as
``jnp.triu_indices`` gives it) join the bottom output in the top MLP, which
ends in one logit under a sigmoid-cross-entropy loss. Float32 products run
in full float32 (the train step turns TF32 off).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..nn import layers as L
from .common import SparseModel
from .dcn import optax_sigmoid_ce


class DLRMDense(nn.Module):
    """DLRM's towers; names follow the JAX parameter pytree (``bottom``,
    ``top``)."""

    def __init__(self, num_numeric: int, bottom_hidden: Sequence[int],
                 top_in: int, top_hidden: Sequence[int],
                 generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.bottom = L.MLP(num_numeric, list(bottom_hidden),
                            final_activation=torch.relu, **kw)
        self.top = L.MLP(top_in, list(top_hidden) + [1], **kw)


class DLRM(SparseModel):
    def __init__(self, num_tables: int = 8, embedding_dim: int = 32,
                 num_numeric: int = 13, bottom_hidden=(64, 32),
                 top_hidden=(64, 32), capacity: int = 1 << 14):
        if bottom_hidden[-1] != embedding_dim:
            raise ValueError("bottom MLP must project numeric features to "
                             "embedding_dim")
        self.num_tables = num_tables
        self.embedding_dim = embedding_dim
        self.num_numeric = num_numeric
        self.bottom_hidden = tuple(bottom_hidden)
        self.top_hidden = tuple(top_hidden)
        self.table_specs = {
            f"T{i}": dict(dim=embedding_dim, capacity=capacity)
            for i in range(num_tables)
        }
        n_feat = num_tables + 1
        self.num_pairs = n_feat * (n_feat - 1) // 2
        self.top_in = embedding_dim + self.num_pairs

    def init_dense(self, generator: torch.Generator, device) -> DLRMDense:
        return DLRMDense(self.num_numeric, self.bottom_hidden, self.top_in,
                         self.top_hidden, generator, device)

    def apply(self, dense: DLRMDense, embeddings: Dict[str, torch.Tensor],
              features):
        x_num = dense.bottom(features)                       # [B, D]
        feats = [x_num] + [embeddings[f"T{i}"] for i in range(self.num_tables)]
        t = torch.stack(feats, dim=1)                        # [B, F, D]
        z = torch.bmm(t, t.transpose(1, 2))                  # [B, F, F]
        iu, ju = torch.triu_indices(t.shape[1], t.shape[1], 1,
                                    device=t.device)
        inter = z[:, iu, ju]                                 # [B, F(F-1)/2]
        return dense.top(torch.cat([x_num, inter], dim=-1))[..., 0]

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))
