"""The sparse side in plain PyTorch: KV rows keyed by id, the row a fresh id
starts from, the optimizer rules (sparse: SGD, Adam, GroupAdam; dense: SGD,
Adam), and a few training steps of a sparse model.

A table here is a sorted array of the ids that the steps touch with their
rows and slot columns. A fresh id starts from the mean of two rows of the
table's init pool, chosen by two murmur3-mixed hashes of the id's 32-bit
words (the KvVariable rule). The sparse optimizers are TFPlus's update
rules written out again (``python/training/gradient_descent.py``
scatter-sub; ``python/training/adam.py`` lazy Adam; ``training_ops.cc``
GroupAdam V4 with l1, l2 and l21 scaled by the learning rate).

:data:`RULES` and :data:`DENSE_RULES` are the one table of the rules the
benchmark knows: for each, the port's constructor, the slot width, the
reference's update, and how the program's first gradient is read back after
step 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for ``a`` in ``[0, 2**32)``, kept inside int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash(ids: torch.Tensor, seed: int) -> torch.Tensor:
    lo = ids & M32
    hi = (ids >> 32) & M32
    h = _fmix32((lo + seed) & M32)
    return _fmix32(h ^ _mul32(hi, 0x9E3779B9) ^ ((seed * 0x01000193) & M32))


def fresh_rows(ids: torch.Tensor, pool: torch.Tensor,
               dtype=torch.float64) -> torch.Tensor:
    """Rows that fresh ``ids`` (non-negative int64) start from."""
    n = pool.shape[0]
    r1 = _hash(ids, 0x1B873593) % n
    r2 = _hash(ids, 0xCC9E2D51) % n
    return (pool[r1].to(dtype) + pool[r2].to(dtype)) * 0.5


def sigmoid_ce_mean(logits: torch.Tensor, labels: torch.Tensor):
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def adam_rows(var, slots, g, lr, t, b1=0.9, b2=0.999, eps=1e-8, **_):
    """Lazy Adam on the touched rows; slots ``[m | v]``."""
    d = var.shape[1]
    m = b1 * slots[:, :d] + (1 - b1) * g
    v = b2 * slots[:, d:] + (1 - b2) * g * g
    lr_t = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    return var - lr_t * m / (eps + torch.sqrt(v)), torch.cat([m, v], 1), None


def group_adam_rows(var, slots, g, lr, t, b1=0.9, b2=0.999, eps=1e-8,
                    l1=0.0, l2=0.0, l21=0.0, **_):
    """GroupAdam V4 on the touched rows; slots ``[m | v | linear]``.
    Returns the blacklist mask beside the rows (a group that the l21 term
    zeroes)."""
    d = var.shape[1]
    m0, v0, lin = slots[:, :d], slots[:, d:2 * d], slots[:, 2 * d:]
    alpha = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    m = b1 * m0 + (1 - b1) * g
    v = b2 * v0 + (1 - b2) * g * g
    nvs = torch.sqrt(v)
    sigma = nvs + eps if t == 1 else nvs - torch.sqrt(v0)
    lin = lin + alpha * m - sigma * var
    l1, l2, l21 = l1 * lr, l2 * lr, l21 * lr
    shrunk = torch.clamp(lin, -l1, l1) - lin
    nrm = torch.linalg.vector_norm(shrunk, dim=1)
    thr = l21 * math.sqrt(d)
    keep = nrm > thr
    scale = 1 - thr / torch.clamp(nrm, min=1e-30)
    new = shrunk * scale[:, None] / (nvs + eps + 2 * l2)
    new = torch.where(keep[:, None], new, torch.zeros_like(new))
    return new, torch.cat([m, v, lin], 1), ~keep


def sgd_rows(var, slots, g, lr, t, **_):
    """Plain gradient descent on the touched rows; no slots."""
    return var - lr * g, slots, None


def adam_dense(p, state, g, lr, t):
    """``torch.optim.Adam`` with betas 0.9, 0.999 and eps 1e-8 on a dense
    leaf; ``state`` is ``(m, v)``, None before the first step."""
    m, v = state if state is not None else (torch.zeros_like(p),) * 2
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    return p - lr / bc1 * m / (torch.sqrt(v) / math.sqrt(bc2) + 1e-8), (m, v)


def sgd_dense(p, state, g, lr, t):
    """``torch.optim.SGD`` without momentum or decay on a dense leaf."""
    return p - lr * g, state


@dataclasses.dataclass(frozen=True)
class Rule:
    """One optimizer rule as the benchmark runs it.

    ``port`` is the constructor the program builds it with (for a table, a
    function of ``tfplus_tpu_torch``'s ``train`` module; for the towers, a
    class of ``torch.optim``) and ``args`` its keyword arguments, each
    from a key of the configuration's optimizer entry. ``width`` is the
    state the rule keeps per value: in a table, the slot columns per
    embedding column of its payload. ``update`` is the reference's update:
    ``(rows, slots, g, lr, t, **kw) -> (rows, slots, blacklisted or None)``
    for a table, ``(leaf, state, g, lr, t) -> (leaf, state)`` for the
    towers. ``first_grad`` is how the program's first gradient is read back
    after step 1: ``"moment"``, the first moment the rule keeps over ``1 -
    b1``; ``"step"``, (the seeded value - the value after step 1) / lr,
    which carries the rounding of the float32 value after step 1 (up to
    half an ulp of the value, and as much again for a fresh row's initial
    value, which the program averages in float32) over lr into the
    gradient read."""
    port: str
    args: tuple
    width: int
    update: Callable
    first_grad: str


_ADAM_ARGS = (("beta1", "b1"), ("beta2", "b2"), ("epsilon", "eps"))
RULES = {
    "sgd": Rule("GradientDescentOptimizer", (), 0, sgd_rows, "step"),
    "adam": Rule("AdamOptimizer", _ADAM_ARGS, 2, adam_rows, "moment"),
    "group_adam": Rule(
        "GroupAdamOptimizer",
        _ADAM_ARGS + (("l1_regularization_strength", "l1"),
                      ("l2_regularization_strength", "l2"),
                      ("l21_regularization_strength", "l21")),
        3, group_adam_rows, "moment"),
}
DENSE_RULES = {
    "sgd": Rule("SGD", (("lr", "lr"),), 0, sgd_dense, "step"),
    "adam": Rule("Adam", (("lr", "lr"),), 2, adam_dense, "moment"),
}


def rule(spec: dict, dense: bool = False) -> Rule:
    """The rule that an optimizer entry (``{"rule": ..., ...}``) names;
    ValueError for one the benchmark does not know."""
    table = DENSE_RULES if dense else RULES
    if spec["rule"] not in table:
        raise ValueError(f"unknown {'dense' if dense else 'sparse'} "
                         f"optimizer rule {spec['rule']!r}; known: "
                         f"{sorted(table)}")
    return table[spec["rule"]]


class Table:
    """The rows of the ids that some steps touch, sorted by id."""

    def __init__(self, ids: np.ndarray, rows: torch.Tensor, slot_width: int):
        self.ids = ids
        self.var = rows.clone()
        self.slots = rows.new_zeros((rows.shape[0], slot_width * rows.shape[1]))
        self.black = torch.zeros(rows.shape[0], dtype=torch.bool,
                                 device=rows.device)

    def index(self, ids: np.ndarray) -> torch.Tensor:
        pos = np.searchsorted(self.ids, ids)
        return torch.from_numpy(pos).to(self.var.device)

    def read(self, idx: torch.Tensor) -> torch.Tensor:
        rows = self.var[idx]
        return torch.where(self.black[idx][:, None], torch.zeros_like(rows),
                           rows)


def train(forward, weights, batches, initial_rows, sparse, dense,
          *, dtype=torch.float64, device="cpu", loss_rows=None):
    """Train from ``weights`` (name -> tensor) and tables that start from
    ``initial_rows(table, ids)`` through ``batches`` (each with
    ``ids[table]`` as host int64 arrays, ``features`` and ``labels``).

    ``forward(params, embs, features) -> logits`` is the model family's
    forward, ``embs[table]`` the rows of that table's id stream in input
    order. ``sparse = dict(rule=..., lr=..., b1=..., ...)`` names the sparse
    rule and ``dense = dict(rule=..., lr=...)`` the dense one (see
    :data:`RULES`). ``loss_rows`` keeps the loss over the first that many
    examples only (a planted fault).

    Returns ``losses`` per step, ``grads`` (leaf -> the first step's
    gradient: dense leaves whole, a table's rows for the ids of step 1 in
    sorted order), ``initial`` and ``final`` (leaf -> tensor, tables over
    every id touched, sorted) and ``ids`` (table -> the sorted ids touched,
    and ``ids1`` those of step 1).
    """
    def on(x):
        return torch.as_tensor(np.asarray(x)).to(device, dtype)

    sparse_rule, dense_rule = rule(sparse), rule(dense, dense=True)
    opt_kw = {k: v for k, v in sparse.items() if k not in ("rule", "lr")}
    names = sorted(batches[0]["ids"])
    touched = {n: np.unique(np.concatenate([b["ids"][n] for b in batches]))
               for n in names}
    tables = {n: Table(touched[n], initial_rows(n, touched[n]).to(device,
                                                                   dtype),
                       sparse_rule.width) for n in names}
    params = {k: v.detach().to(device, dtype).clone()
              for k, v in weights.items()}
    initial = {k: v.clone() for k, v in params.items()}
    initial.update({f"table:{n}": t.var.clone() for n, t in tables.items()})
    dense_state = dict.fromkeys(params)
    losses, grads, ids1 = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        leaves, embs, idx = {}, {}, {}
        for n in names:
            uniq, inv = np.unique(batch["ids"][n], return_inverse=True)
            idx[n] = tables[n].index(uniq)
            leaves[n] = tables[n].read(idx[n]).requires_grad_()
            embs[n] = leaves[n][torch.from_numpy(inv.reshape(-1)).to(device)]
            if t == 1:
                ids1[n] = uniq
        p = {k: x.requires_grad_() for k, x in params.items()}
        feats = batch["features"]
        feats = ({k: on(x) for k, x in feats.items()}
                 if isinstance(feats, dict) else on(feats))
        logits = forward(p, embs, feats)
        labels = on(batch["labels"])
        if loss_rows is not None:
            logits, labels = logits[:loss_rows], labels[:loss_rows]
        loss = sigmoid_ce_mean(logits, labels)
        keys = list(p)
        g = torch.autograd.grad(loss, [p[k] for k in keys]
                                + [leaves[n] for n in names],
                                allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi
             for gi, x in zip(g, [p[k] for k in keys]
                              + [leaves[n] for n in names])]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, gk in zip(keys, g):
                params[k], dense_state[k] = dense_rule.update(
                    params[k].detach(), dense_state[k], gk, dense["lr"], t)
            for n, gn in zip(names, g[len(keys):]):
                tab = tables[n]
                var = tab.read(idx[n])
                new, slots, black = sparse_rule.update(
                    var, tab.slots[idx[n]], gn, sparse["lr"], t, **opt_kw)
                tab.var[idx[n]] = new
                tab.slots[idx[n]] = slots
                tab.black[idx[n]] = (black if black is not None
                                     else torch.zeros_like(tab.black[idx[n]]))
        if t == 1:
            grads = {k: gk.detach() for k, gk in zip(keys, g)}
            grads.update({f"table:{n}": gn.detach()
                          for n, gn in zip(names, g[len(keys):])})
    final = {k: x.detach() for k, x in params.items()}
    final.update({f"table:{n}": t.read(torch.arange(t.ids.shape[0],
                                                    device=device))
                  for n, t in tables.items()})
    return {"losses": losses, "grads": grads, "initial": initial,
            "final": final, "ids": touched, "ids1": ids1}


def predict(forward, weights, batch, rows, *, dtype=torch.float64,
            device="cpu"):
    """Serving: logits of ``batch`` with ``rows(table, ids)`` giving each
    stream's rows (zeros for ids the tables do not hold)."""
    with torch.no_grad():
        p = {k: v.to(device, dtype) for k, v in weights.items()}
        embs = {n: rows(n, np.asarray(ids)).to(device, dtype)
                for n, ids in batch["ids"].items()}
        feats = batch["features"]
        feats = ({k: torch.as_tensor(x).to(device, dtype)
                  for k, x in feats.items()} if isinstance(feats, dict)
                 else torch.as_tensor(feats).to(device, dtype))
        return forward(p, embs, feats)
