"""DCN (arXiv:1708.05123) in plain PyTorch: the embeddings of the
categorical features in order and the numeric features form ``x0``; a deep
tower (relu after every layer) and a cross network
(``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``) each end in one logit, and the
two logits add. Parameter names: ``dnn.{i}.w/b``, ``dnn_logits.w/b``,
``cross.{i}.w/b``, ``cross_logits.w/b`` (kernels ``[in, out]``)."""
from __future__ import annotations

import torch


def make_forward(cfg: dict):
    """``forward(params, embs, features) -> logits`` for a DCN config."""
    names = [f"C{i + 1}" for i in range(len(cfg["embedding_dims"]))]
    hidden = len(cfg["dnn_hidden"])
    cross = cfg["cross_layers"]

    def forward(p, embs, features):
        x0 = torch.cat([embs[n] for n in names] + [features], dim=1)
        h = x0
        for i in range(hidden):
            h = torch.relu(h @ p[f"dnn.{i}.w"] + p[f"dnn.{i}.b"])
        deep = h @ p["dnn_logits.w"] + p["dnn_logits.b"]
        x = x0
        for i in range(cross):
            xw = torch.sum(x * p[f"cross.{i}.w"], dim=1, keepdim=True)
            x = x0 * xw + p[f"cross.{i}.b"] + x
        return (deep + x @ p["cross_logits.w"] + p["cross_logits.b"])[:, 0]

    return forward
