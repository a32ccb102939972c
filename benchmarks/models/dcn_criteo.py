"""DCN at TFPlus's reference widths, on ``tfplus_tpu_torch.models.DCN``:
26 KV tables (one per categorical feature), 13 numeric features, a deep
tower and a cross network. Weights are RandomNormal(0, 0.1), the model's
own initialiser, drawn from the seed."""
from __future__ import annotations

FAMILY = "dcn"


def _names(cfg):
    return [f"C{i + 1}" for i in range(len(cfg["embedding_dims"]))]


def tables(cfg):
    return {n: (d, cfg["rows_per_table"], cfg["keys_per_table"])
            for n, d in zip(_names(cfg), cfg["embedding_dims"])}


def make_model(cfg, models):
    return models.DCN(embedding_dims=cfg["embedding_dims"],
                      num_numeric=cfg["num_numeric"],
                      dnn_hidden=cfg["dnn_hidden"],
                      cross_layers=cfg["cross_layers"],
                      capacity=cfg["rows_per_table"])


def _input_dim(cfg):
    return sum(cfg["embedding_dims"]) + cfg["num_numeric"]


def dense_spec(cfg):
    w = b = ["normal", cfg["dense_init_scale"]]
    d_in = prev = _input_dim(cfg)
    spec = []
    for i, h in enumerate(cfg["dnn_hidden"]):
        spec += [(f"dnn.{i}.w", (prev, h), w), (f"dnn.{i}.b", (h,), b)]
        prev = h
    spec += [("dnn_logits.w", (prev, 1), w), ("dnn_logits.b", (1,), b)]
    for i in range(cfg["cross_layers"]):
        spec += [(f"cross.{i}.w", (d_in,), w), (f"cross.{i}.b", (d_in,), b)]
    spec += [("cross_logits.w", (d_in, 1), w), ("cross_logits.b", (1,), b)]
    return spec


def draw(tr, cfg):
    b = tr.mix["batch"]
    return {"ids": {n: tr.ids(n, (b,)) for n in _names(cfg)},
            "features": tr.normal((b, cfg["num_numeric"])),
            "labels": tr.labels(b)}


def forward_flops(batch, cfg):
    """Products of the deep tower (2 per multiply-add) and the cross
    network's dot products, per batch."""
    d_in = prev = _input_dim(cfg)
    per = 0
    for h in list(cfg["dnn_hidden"]) + [1]:
        per += 2 * prev * h
        prev = h
    per += 2 * d_in * (cfg["cross_layers"] + 1)
    return per * batch["labels"].shape[0]


def attention_work(batch, cfg):
    return None
