"""BST — Behavior Sequence Transformer for CTR (arXiv:1905.06874).

Counterpart of ``tfplus_tpu/models/bst.py``: transformer blocks over the
sequence ``[history..., candidate]`` with learned positions, pre-LN residual
blocks whose multi-head self-attention goes through
:func:`tfplus_tpu_torch.nn.attention.flash_attention_layer` (segment-id
masking; on the card the single-pass flash kernel), and a masked mean pool
into the CTR tower. The item and user tables are wired as in DIN. The
sequence axis is padded to ``pad_to`` positions with mask 0, as the JAX
model pads it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import layers as L
from ..nn.attention import flash_attention_layer
from .common import SparseModel
from .dcn import optax_sigmoid_ce
from .din import DIN


class LayerNorm(nn.Module):
    """Layer norm with eps 1e-6 and ``rsqrt``, parameters ``g`` and ``b``
    (the JAX model's ``_ln``, not ``nn.LayerNorm``'s eps 1e-5)."""

    def __init__(self, dim: int, device, eps: float = 1e-6):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.g + self.b


class BSTBlock(nn.Module):
    def __init__(self, d: int, inner: int, ffn_hidden: int, **kw):
        super().__init__()
        dev = kw["device"]
        self.ln1 = LayerNorm(d, dev)
        self.ln2 = LayerNorm(d, dev)
        self.qkv = L.Dense(d, 3 * inner, scale=0.05, **kw)
        self.proj = L.Dense(inner, d, scale=0.05, **kw)
        self.ffn1 = L.Dense(d, ffn_hidden, torch.relu, scale=0.05, **kw)
        self.ffn2 = L.Dense(ffn_hidden, d, scale=0.05, **kw)


class BSTDense(nn.Module):
    """BST's dense parts; names follow the JAX parameter pytree (``pos``,
    ``dnn``, ``dnn_logits``, ``blocks.{i}.{ln1,ln2,qkv,proj,ffn1,ffn2}``)."""

    def __init__(self, model: "BST", generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d = model.embedding_dim
        self.pos = nn.Parameter(
            (torch.randn((model.seq_len + 1, d), generator=generator) * 0.02)
            .to(device))
        self.dnn = L.MLP(model.input_dim, list(model.dnn_hidden),
                         final_activation=torch.relu, **kw)
        self.dnn_logits = L.Dense(model.dnn_hidden[-1], 1, **kw)
        self.blocks = nn.ModuleList(
            BSTBlock(d, model.num_heads * model.head_dim, model.ffn_hidden,
                     **kw) for _ in range(model.num_blocks))


class BST(SparseModel):
    def __init__(self, embedding_dim: int = 32, seq_len: int = 31,
                 num_numeric: int = 4, num_heads: int = 2,
                 head_dim: int = 32, num_blocks: int = 1,
                 ffn_hidden: int = 64, dnn_hidden=(128, 64),
                 capacity: int = 1 << 14, pad_to: int = 128):
        self.embedding_dim = embedding_dim
        self.seq_len = seq_len              # history length; +1 candidate
        self.num_numeric = num_numeric
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.ffn_hidden = ffn_hidden
        self.dnn_hidden = tuple(dnn_hidden)
        self.pad_to = pad_to
        self.table_specs = {
            "item": dict(dim=embedding_dim, capacity=capacity),
            "user": dict(dim=embedding_dim, capacity=capacity),
        }
        # [user, pooled, cand_token, numeric]
        self.input_dim = 3 * embedding_dim + num_numeric

    # DIN's shared-item-table id packing (candidate first, then history)
    pack_item_ids = staticmethod(DIN.pack_item_ids)

    def init_dense(self, generator: torch.Generator, device) -> BSTDense:
        return BSTDense(self, generator, device)

    def apply(self, dense: BSTDense, embeddings: Dict[str, torch.Tensor],
              features):
        mask = features["mask"]                         # [B, L]
        b, hist = mask.shape
        e = embeddings["item"]
        cand = e[:b]
        seq = e[b:].reshape(b, hist, self.embedding_dim)
        user = embeddings["user"]

        # tokens = [history..., candidate]; learned positions
        x = torch.cat([seq, cand[:, None, :]], dim=1) + dense.pos[None,
                                                                   :hist + 1]
        tok_mask = torch.cat([mask, mask.new_ones((b, 1))], dim=1)
        # pad the sequence axis; padded positions carry mask 0 (segment -1)
        pad = (-(hist + 1)) % self.pad_to
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            tok_mask = F.pad(tok_mask, (0, pad))

        sp = x.shape[1]
        heads, dh = self.num_heads, self.head_dim
        for blk in dense.blocks:
            q, k, v = blk.qkv(blk.ln1(x)).chunk(3, dim=-1)
            att = flash_attention_layer(q.reshape(b, sp, heads, dh),
                                        k.reshape(b, sp, heads, dh),
                                        v.reshape(b, sp, heads, dh),
                                        attention_mask=tok_mask)
            x = x + blk.proj(att.reshape(b, sp, heads * dh))
            x = x + blk.ffn2(blk.ffn1(blk.ln2(x)))

        # masked mean pool over real tokens + the candidate's own token
        w = tok_mask[..., None]
        pooled = (x * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        cand_tok = x[:, hist]
        deep_in = torch.cat([user, pooled, cand_tok, features["numeric"]],
                            dim=-1)
        return dense.dnn_logits(dense.dnn(deep_in))[..., 0]

    def loss(self, logits, labels):
        return torch.mean(optax_sigmoid_ce(logits, labels.to(logits.dtype)))
