"""Helpers the example twins share: the sparse optimizer by its flag name,
and the AUC and accuracy of an eval pass."""
from __future__ import annotations

from typing import Tuple

import numpy as np

OPTIMIZERS = ("adam", "adagrad", "group_adam", "sparse_group_ftrl")


def sparse_optimizer(name: str, lr: float):
    """The ``--optimizer`` choice of the CTR twins."""
    from .. import train as tft
    return {"adam": tft.AdamOptimizer,
            "adagrad": tft.AdagradOptimizer,
            "group_adam": tft.GroupAdamOptimizer,
            "sparse_group_ftrl": tft.SparseGroupFtrlOptimizer,
            }[name](learning_rate=lr)


def auc_accuracy(labels, scores) -> Tuple[float, float]:
    """``(accuracy, AUC)`` of logits ``scores`` against 0/1 ``labels``:
    accuracy of ``score > 0``, AUC by the rank-sum formula (ties broken by
    sort order, as the JAX examples compute it)."""
    labels = np.concatenate(labels) if isinstance(labels, list) else labels
    scores = np.concatenate(scores) if isinstance(scores, list) else scores
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    auc = ((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
           / max(pos.sum() * (~pos).sum(), 1))
    acc = ((scores > 0) == pos).mean()
    return float(acc), float(auc)
