"""BST (arXiv:1905.06874) in plain PyTorch over the unpadded tokens.

The item stream holds the candidates, then the histories row by row; the
tokens are ``[history..., candidate]`` plus learned positions. Each block is
pre-LN (eps 1e-6): multi-head self-attention over the valid tokens (a
history's padding is masked out as query and as key), a projection and a
relu FFN, each added to the residual. The valid tokens are mean-pooled;
``[user, pooled, candidate token, numeric]`` feeds the MLP (relu after
every layer) and its logit."""
from __future__ import annotations

import math

import torch


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


def make_forward(cfg: dict):
    d = cfg["embedding_dim"]
    heads, dh = cfg["num_heads"], cfg["head_dim"]
    blocks, hidden = cfg["num_blocks"], len(cfg["dnn_hidden"])

    def forward(p, embs, features):
        mask = features["mask"]
        b, hist = mask.shape
        e = embs["item"]
        x = (torch.cat([e[b:].reshape(b, hist, d), e[:b, None]], dim=1)
             + p["pos"][None, :hist + 1])
        tok = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1) > 0
        valid = tok[:, None, :, None] & tok[:, None, None, :]
        n = hist + 1
        for i in range(blocks):
            pre = f"blocks.{i}"
            h = _ln(x, p[f"{pre}.ln1.g"], p[f"{pre}.ln1.b"])
            qkv = h @ p[f"{pre}.qkv.w"] + p[f"{pre}.qkv.b"]
            q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            s = torch.where(valid, q @ k.transpose(-1, -2) / math.sqrt(dh),
                            torch.full_like(valid, -1e30, dtype=q.dtype))
            w = torch.exp(s - s.amax(-1, keepdim=True)) * valid
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
            att = (w @ v).transpose(1, 2).reshape(b, n, heads * dh)
            x = x + att @ p[f"{pre}.proj.w"] + p[f"{pre}.proj.b"]
            y = torch.relu(_ln(x, p[f"{pre}.ln2.g"], p[f"{pre}.ln2.b"])
                           @ p[f"{pre}.ffn1.w"] + p[f"{pre}.ffn1.b"])
            x = x + y @ p[f"{pre}.ffn2.w"] + p[f"{pre}.ffn2.b"]
        wt = tok[..., None].to(x.dtype)
        pooled = (x * wt).sum(1) / torch.clamp(wt.sum(1), min=1.0)
        h = torch.cat([embs["user"], pooled, x[:, hist], features["numeric"]],
                      dim=-1)
        for i in range(hidden):
            h = torch.relu(h @ p[f"dnn.{i}.w"] + p[f"dnn.{i}.b"])
        return (h @ p["dnn_logits.w"] + p["dnn_logits.b"])[:, 0]

    return forward
