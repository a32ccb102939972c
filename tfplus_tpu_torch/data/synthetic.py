"""Synthetic dataset generators with learnable structure.

Counterpart of ``tfplus_tpu/data/synthetic.py``, numpy only: the same
generators give the same arrays from the same seed. The reference's examples
train on MovieLens-100k and Criteo-Kaggle; where those are not on disk,
these generators produce statistically similar data with a planted
ground-truth model, making loss-decrease and AUC targets meaningful (a real
Criteo TSV is read by ``tfplus_tpu_torch.data.criteo``).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def movielens_like(n_examples: int = 100_000, n_users: int = 943,
                   n_movies: int = 1682, latent: int = 8, seed: int = 0):
    """MovieLens-100k-shaped ratings: rating = <u, m> latent structure + noise,
    clipped to [1, 5] (100k ratings / 943 users / 1682 movies)."""
    rng = np.random.RandomState(seed)
    u_emb = rng.randn(n_users, latent) * 0.7
    m_emb = rng.randn(n_movies, latent) * 0.7
    users = rng.randint(0, n_users, n_examples).astype(np.int64)
    movies = rng.randint(0, n_movies, n_examples).astype(np.int64)
    raw = 3.0 + (u_emb[users] * m_emb[movies]).sum(1) + rng.randn(n_examples) * 0.3
    ratings = np.clip(raw, 1.0, 5.0).astype(np.float32)
    return {"user_id": users, "movie_id": movies, "rating": ratings}


class CriteoLike:
    """Criteo-Kaggle-shaped stream: 13 numeric + 26 categorical columns with
    zipf-distributed hashed ids and a planted logistic ground truth."""

    def __init__(self, seed: int = 0, num_numeric: int = 13,
                 num_categorical: int = 26,
                 vocab_sizes=None, zipf: float = 1.2):
        rng = np.random.RandomState(seed)
        self.num_numeric = num_numeric
        self.num_categorical = num_categorical
        self.vocab_sizes = (vocab_sizes if vocab_sizes is not None
                            else rng.choice([1000, 5000, 20000, 100000],
                                            num_categorical))
        self.zipf = zipf
        # planted truth: per-column per-id weight + numeric weights
        self._id_w = [rng.randn(v) * 1.2 for v in self.vocab_sizes]
        self._num_w = rng.randn(num_numeric) * 0.4
        self._rng = rng

    def batches(self, batch_size: int, num_batches: int
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = self._rng
        for _ in range(num_batches):
            numeric = rng.lognormal(0.0, 1.0,
                                    (batch_size, self.num_numeric)).astype(np.float32)
            numeric = np.log1p(numeric)   # standard criteo transform
            cats = np.zeros((batch_size, self.num_categorical), np.int64)
            logit = numeric @ self._num_w
            for c, v in enumerate(self.vocab_sizes):
                ids = rng.zipf(self.zipf, batch_size) % v
                cats[:, c] = ids
                logit = logit + self._id_w[c][ids]
            logit = (logit - logit.mean()) / (logit.std() + 1e-6) * 2.0
            p = 1.0 / (1.0 + np.exp(-logit))
            labels = (rng.rand(batch_size) < p).astype(np.float32)
            # globally-unique id space per column (column tag in high bits)
            cats = cats + (np.arange(self.num_categorical, dtype=np.int64)
                           << 40)[None, :]
            yield {"numeric": numeric, "categorical": cats, "label": labels}


def dlrm_batches(batch_size: int, num_batches: int, num_tables: int = 8,
                 num_numeric: int = 13, vocab: int = 50_000, seed: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    gen = CriteoLike(seed=seed, num_numeric=num_numeric,
                     num_categorical=num_tables,
                     vocab_sizes=[vocab] * num_tables)
    yield from gen.batches(batch_size, num_batches)


class BehaviorSequence:
    """Planted-interest sequence data for DIN-style models.

    Items live in ``n_clusters`` latent clusters. Each example has a
    LATENT interest cluster: the click history is drawn from it (variable
    length, zero-padded to ``seq_len``) and the candidate item is
    positive-biased when its cluster matches. The interest is per-example
    — not a function of the user id — so only sequence attention over the
    history can recover it; user-embedding memorization cannot.
    """

    def __init__(self, n_items: int = 2000, n_users: int = 500,
                 n_clusters: int = 20, seq_len: int = 16,
                 num_numeric: int = 4, seed: int = 0,
                 pref_strength: float = 0.8, logit_scale: float = 2.5,
                 logit_bias: float = -1.2):
        self.rng = np.random.RandomState(seed)
        self.n_items, self.n_users = n_items, n_users
        self.n_clusters, self.seq_len = n_clusters, seq_len
        self.num_numeric = num_numeric
        self.pref_strength = pref_strength
        self.logit_scale = logit_scale
        self.logit_bias = logit_bias
        # item -> cluster (ids are 1-based; 0 is the pad id)
        self.item_cluster = self.rng.randint(0, n_clusters, size=n_items + 1)
        self.w_num = self.rng.randn(num_numeric).astype(np.float32) * 0.3
        # per-cluster item lists, padded square for vectorized sampling
        members = [np.where(self.item_cluster[1:] == c)[0] + 1
                   for c in range(n_clusters)]
        self.cluster_count = np.array([max(len(m), 1) for m in members])
        width = int(self.cluster_count.max())
        self.cluster_table = np.zeros((n_clusters, width), np.int64)
        for c, m in enumerate(members):
            if len(m) == 0:          # degenerate tiny-vocab case
                m = np.array([1 + c % self.n_items])
            self.cluster_table[c] = np.resize(m, width)

    def batches(self, batch_size: int, num_batches: int
                ) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(num_batches):
            b, L = batch_size, self.seq_len
            user = self.rng.randint(1, self.n_users + 1, b)
            # the interest is LATENT and per-example (not a user-id
            # function): the model can only infer it from the history,
            # so user-embedding memorization cannot shortcut attention
            pref = self.rng.randint(0, self.n_clusters, b)
            # history: pref_strength of the items from the latent interest
            # cluster, rest noise; variable length (>=4), zero-padded tail
            lengths = self.rng.randint(min(4, L), L + 1, b)
            pos = np.arange(L)[None, :] < lengths[:, None]     # [b, L]
            cl = np.where(self.rng.rand(b, L) < self.pref_strength,
                          pref[:, None],
                          self.rng.randint(0, self.n_clusters, (b, L)))
            idx = (self.rng.rand(b, L)
                   * self.cluster_count[cl]).astype(np.int64)
            seq = np.where(pos, self.cluster_table[cl, idx], 0)
            mask = pos.astype(np.float32)
            # half the candidates come from the interest cluster (balanced
            # match rate — a rare match would cap the achievable AUC)
            idxc = (self.rng.rand(b) * self.cluster_count[pref]).astype(
                np.int64)
            cand = np.where(self.rng.rand(b) < 0.5,
                            self.cluster_table[pref, idxc],
                            self.rng.randint(1, self.n_items + 1, b))
            hist_match = (self.item_cluster[cand] == pref).astype(np.float32)
            numeric = self.rng.randn(b, self.num_numeric).astype(np.float32)
            logit = (self.logit_scale * hist_match + self.logit_bias
                     + numeric @ self.w_num)
            label = (self.rng.rand(b) < 1.0 / (1.0 + np.exp(-logit))
                     ).astype(np.float32)
            yield {"user": user, "cand": cand, "seq": seq, "mask": mask,
                   "numeric": numeric, "label": label}
