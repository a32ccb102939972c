"""MovieLens-100k reader (the reference NCF example's dataset,
example/NCFModel/train.py: downloads ml-100k and reads ``u.data``).
Counterpart of ``tfplus_tpu/data/movielens.py``, with the same search path
and environment variable.

``u.data`` format: ``user_id \\t item_id \\t rating \\t timestamp`` — 100k
rows, 943 users, 1682 items. Zero-egress environments won't have the
download; :func:`load` reads an on-disk copy (``MOVIELENS_PATH`` env or
the common locations) and callers fall back to
``data.synthetic.movielens_like`` when absent (the examples do).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def available(path: Optional[str] = None) -> Optional[str]:
    for cand in ([path] if path else []) + [
            os.environ.get("MOVIELENS_PATH", ""),
            "/data/ml-100k/u.data", "/root/data/ml-100k/u.data"]:
        if cand and os.path.exists(cand):
            return cand
    return None


def load(path: str, *, shuffle_seed: Optional[int] = 2021
         ) -> Dict[str, np.ndarray]:
    """Load ``u.data`` → ``{"user_id", "movie_id", "rating"}`` (the NCF
    example's columns; ratings as f32 for the MSE head)."""
    raw = np.loadtxt(path, dtype=np.int64, delimiter="\t")
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed)
        raw = raw[rng.permutation(len(raw))]
    return {
        "user_id": raw[:, 0].astype(np.int64),
        "movie_id": raw[:, 1].astype(np.int64),
        "rating": raw[:, 2].astype(np.float32),
    }


def load_or_synthetic(n_examples: int = 100_000, *,
                      path: Optional[str] = None,
                      seed: int = 2021) -> Dict[str, np.ndarray]:
    """Real ml-100k when on disk, else the synthetic MovieLens-shaped
    stream (same columns/cardinalities)."""
    p = available(path)
    if p is not None:
        return load(p, shuffle_seed=seed)
    from . import synthetic
    return synthetic.movielens_like(n_examples, seed=seed)
