"""BST at its published widths, on ``tfplus_tpu_torch.models.BST``: an item
table shared by candidates and histories, a user table, transformer blocks
over ``[history..., candidate]`` padded to ``pad_to`` positions, and an MLP.
Weights follow the model's own initialisers (dense layers RandomNormal(0,
0.1), the blocks' 0.05, positions 0.02, layer norms 1 and 0), drawn from
the seed."""
from __future__ import annotations

import numpy as np
import torch

FAMILY = "bst"


def tables(cfg):
    d = cfg["embedding_dim"]
    return {"item": (d, cfg["item_rows"], cfg["item_keys"]),
            "user": (d, cfg["user_rows"], cfg["user_keys"])}


def make_model(cfg, models):
    model = models.BST(embedding_dim=cfg["embedding_dim"],
                       seq_len=cfg["seq_len"],
                       num_numeric=cfg["num_numeric"],
                       num_heads=cfg["num_heads"], head_dim=cfg["head_dim"],
                       num_blocks=cfg["num_blocks"],
                       ffn_hidden=cfg["ffn_hidden"],
                       dnn_hidden=cfg["dnn_hidden"],
                       capacity=cfg["item_rows"], pad_to=cfg["pad_to"])
    model.table_specs["user"]["capacity"] = cfg["user_rows"]
    return model


def dense_spec(cfg):
    d, f = cfg["embedding_dim"], cfg["ffn_hidden"]
    inner = cfg["num_heads"] * cfg["head_dim"]
    dense = dense_b = ["normal", cfg["dense_init_scale"]]
    block = block_b = ["normal", cfg["block_init_scale"]]
    spec = [("pos", (cfg["seq_len"] + 1, d), ["normal",
                                               cfg["pos_init_scale"]])]
    prev = 3 * d + cfg["num_numeric"]
    for i, h in enumerate(cfg["dnn_hidden"]):
        spec += [(f"dnn.{i}.w", (prev, h), dense),
                 (f"dnn.{i}.b", (h,), dense_b)]
        prev = h
    spec += [("dnn_logits.w", (prev, 1), dense),
             ("dnn_logits.b", (1,), dense_b)]
    for i in range(cfg["num_blocks"]):
        p = f"blocks.{i}"
        spec += [(f"{p}.ln1.g", (d,), ["ones"]), (f"{p}.ln1.b", (d,), ["zeros"]),
                 (f"{p}.ln2.g", (d,), ["ones"]), (f"{p}.ln2.b", (d,), ["zeros"])]
        for name, shape in (("qkv", (d, 3 * inner)), ("proj", (inner, d)),
                            ("ffn1", (d, f)), ("ffn2", (f, d))):
            spec += [(f"{p}.{name}.w", shape, block),
                     (f"{p}.{name}.b", shape[1:], block_b)]
    return spec


def draw(tr, cfg):
    """Candidates and histories from the item table, users from the user
    table; a history of ``n`` items fills its first ``n`` positions and the
    pad id the rest."""
    b, hist = tr.mix["batch"], cfg["seq_len"]
    cand, cand_fresh = tr.ids("item", (b,))
    seq, seq_fresh = tr.ids("item", (b, hist))
    n = tr.lengths(b, hist)
    mask = torch.arange(hist, device=n.device)[None, :] < n[:, None]
    seq = torch.where(mask, seq, tr.mix["pad_id"])
    item = torch.cat([cand, seq.reshape(-1)])
    item_fresh = torch.cat([cand_fresh, (seq_fresh & mask).reshape(-1)])
    return {"ids": {"item": (item, item_fresh), "user": tr.ids("user", (b,))},
            "features": {"numeric": tr.normal((b, cfg["num_numeric"])),
                         "mask": mask.float()},
            "labels": tr.labels(b)}


def _tokens(batch):
    """Valid tokens of each example: its history and its candidate."""
    return batch["features"]["mask"].sum(1).astype(np.float64) + 1


def forward_flops(batch, cfg):
    """Per valid token the blocks' products (qkv, projection, FFN), per
    valid (query, key) pair and head the attention's 4·D, per example the
    MLP; 2 operations per multiply-add."""
    d, f = cfg["embedding_dim"], cfg["ffn_hidden"]
    heads, dh = cfg["num_heads"], cfg["head_dim"]
    inner = heads * dh
    n = _tokens(batch)
    per_token = 2 * (d * 3 * inner + inner * d + 2 * d * f)
    attention = 4 * dh * heads * float((n * n).sum())
    prev, mlp = 3 * d + cfg["num_numeric"], 0
    for h in list(cfg["dnn_hidden"]) + [1]:
        mlp += 2 * prev * h
        prev = h
    return cfg["num_blocks"] * (per_token * float(n.sum()) + attention) \
        + mlp * n.shape[0]


def attention_work(batch, cfg):
    """Valid rows and (row, key) pairs, each per head, of all blocks."""
    n = _tokens(batch)
    k = cfg["num_heads"] * cfg["num_blocks"]
    return {"rows": k * float(n.sum()), "pairs": k * float((n * n).sum()),
            "head_dim": cfg["head_dim"]}
