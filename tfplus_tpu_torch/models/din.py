"""DIN — Deep Interest Network for CTR with behavior-sequence attention.

Counterpart of ``tfplus_tpu/models/din.py`` (arXiv:1706.06978): a learned
activation unit, an MLP over ``[h, c, h*c, h-c]`` per history position,
scores each clicked item against the candidate, and the history pools by
those weights into an interest vector. One shared item table serves the
candidate and the flattened history (see :meth:`DIN.pack_item_ids`).

Batch layout:
  * ``batch["ids"]["item"]``  — ``concat([cand[B], behavior[B*L]])``
  * ``batch["ids"]["user"]``  — ``[B]``
  * ``batch["features"]``     — ``{"numeric": [B, n], "mask": [B, L]}``
    (mask 1.0 at real positions, 0.0 at pad).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..nn import layers as L
from .common import SparseModel
from .dcn import optax_sigmoid_ce


class DINDense(nn.Module):
    """DIN's dense parts; names follow the JAX parameter pytree (``att``,
    ``att_out``, ``dnn``, ``dnn_logits``)."""

    def __init__(self, model: "DIN", generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d = model.embedding_dim
        self.att = L.MLP(4 * d, list(model.att_hidden),
                         final_activation=torch.relu, **kw)
        self.att_out = L.Dense(model.att_hidden[-1], 1, **kw)
        self.dnn = L.MLP(model.input_dim, list(model.dnn_hidden),
                         final_activation=torch.relu, **kw)
        self.dnn_logits = L.Dense(model.dnn_hidden[-1], 1, **kw)


class DIN(SparseModel):
    def __init__(self, embedding_dim: int = 32, seq_len: int = 16,
                 num_numeric: int = 4, att_hidden=(64, 32),
                 dnn_hidden=(128, 64), capacity: int = 1 << 14):
        self.embedding_dim = embedding_dim
        self.seq_len = seq_len
        self.num_numeric = num_numeric
        self.att_hidden = tuple(att_hidden)
        self.dnn_hidden = tuple(dnn_hidden)
        self.table_specs = {
            "item": dict(dim=embedding_dim, capacity=capacity),
            "user": dict(dim=embedding_dim, capacity=capacity),
        }
        # [user, cand, interest, interest*cand, numeric]
        self.input_dim = 4 * embedding_dim + num_numeric

    @staticmethod
    def pack_item_ids(cand_ids: np.ndarray, seq_ids: np.ndarray) -> np.ndarray:
        """One id stream for the shared item table: ``[cand; seq.ravel()]``,
        so the step's dedup probes each unique item once."""
        return np.concatenate([np.asarray(cand_ids).reshape(-1),
                               np.asarray(seq_ids).reshape(-1)])

    def init_dense(self, generator: torch.Generator, device) -> DINDense:
        return DINDense(self, generator, device)

    def apply(self, dense: DINDense, embeddings: Dict[str, torch.Tensor],
              features):
        mask = features["mask"]                       # [B, L] {0, 1}
        b, length = mask.shape
        e = embeddings["item"]                        # [B + B*L, D]
        cand = e[:b]
        seq = e[b:].reshape(b, length, self.embedding_dim)
        user = embeddings["user"]

        cexp = cand[:, None, :].expand_as(seq)
        att_in = torch.cat([seq, cexp, seq * cexp, seq - cexp], dim=-1)
        scores = dense.att_out(dense.att(att_in))[..., 0]       # [B, L]
        scores = torch.where(mask > 0, scores, -1e9)
        # all-pad rows (cold-start user) get a zero interest vector
        w = torch.softmax(scores, dim=-1) * (mask.sum(-1, keepdim=True) > 0)
        interest = torch.einsum("bl,bld->bd", w, seq)

        deep_in = torch.cat([user, cand, interest, interest * cand,
                             features["numeric"]], dim=-1)
        return dense.dnn_logits(dense.dnn(deep_in))[..., 0]

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))
