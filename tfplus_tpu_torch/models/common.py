"""Sparse-model harness: tables, state and the step.

Counterpart of ``tfplus_tpu/models/common.py``. KV tables are explicit state
carried in :class:`TrainState`; the dense towers are an ``nn.Module`` and the
dense optimizer a ``torch.optim.Optimizer`` (the state's ``opt_state``).
Gradients with respect to the looked-up unique rows come from autograd (the
backward of the inverse-index take sums duplicates) and feed the sparse
optimizer, which updates the tables in place.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from .. import embedding as emb
from ..kv import table as kvt
from ..utils import device as _dev
from ..utils import packing


class SparseModel:
    """Protocol: subclass and define table_specs / init_dense / apply / loss."""
    #: name -> dict(dim=..., capacity=..., **kv.create kwargs)
    table_specs: Dict[str, dict] = {}

    def init_dense(self, generator: torch.Generator, device) -> nn.Module:
        raise NotImplementedError

    def apply(self, dense: nn.Module, embeddings: Dict[str, torch.Tensor],
              features):
        """embeddings[name] is [B, D_name]; returns logits/predictions."""
        raise NotImplementedError

    def loss(self, preds, labels):
        raise NotImplementedError

    def init_tables(self, sparse_opt=None, seed: int = 0,
                    device="cuda") -> Dict[str, kvt.KvTable]:
        """One table per spec, with ``sparse_opt``'s slot columns."""
        tables = {}
        for i, (name, spec) in enumerate(sorted(self.table_specs.items())):
            spec = dict(spec)
            spec.setdefault("name", name)
            t = kvt.create(seed=seed + i, device=device, **spec)
            tables[name] = t if sparse_opt is None else sparse_opt.init(t)
        return tables


class TrainState(NamedTuple):
    tables: Dict[str, kvt.KvTable]
    dense: nn.Module
    opt_state: Optional[torch.optim.Optimizer]
    step: torch.Tensor


def init_state(model: SparseModel, sparse_opt=None,
               dense_tx: Optional[Callable] = None, seed: int = 0,
               device="cuda") -> TrainState:
    """Tables (with ``sparse_opt``'s slots) and dense towers on ``device``.

    ``dense_tx`` is a factory ``params -> torch.optim.Optimizer``, e.g.
    ``functools.partial(torch.optim.Adam, lr=1e-3)`` as the twin of
    ``optax.adam(1e-3)``; the optimizer it builds over the towers is the
    state's ``opt_state``. Serving needs neither argument."""
    dev = _dev.resolve(device)
    dense = model.init_dense(torch.Generator().manual_seed(seed), dev)
    return TrainState(tables=model.init_tables(sparse_opt, seed, device=dev),
                      dense=dense,
                      opt_state=(None if dense_tx is None
                                 else dense_tx(dense.parameters())),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _features(features, device):
    if features is None:
        return None
    if isinstance(features, Mapping):
        return {k: _features(v, device) for k, v in features.items()}
    return torch.as_tensor(features, dtype=torch.float32, device=device)


def make_train_step(model: SparseModel, sparse_opt=None, dense_tx=None, *,
                    sparse_lr: Optional[float] = None,
                    train: bool = True) -> Callable:
    """Build ``step(state, batch) -> (state, loss, preds)``.

    ``batch`` = dict with per-table id arrays under ``batch["ids"][name]``
    (rank-1), optional dense ``batch["features"]`` and ``batch["labels"]``.
    Features are an array, which becomes one float32 tensor on the state's
    device, or a dict of arrays (BST/DIN: ``{"numeric", "mask"}``), which
    becomes a dict of such tensors.

    ``train=True``, as the JAX step: per table (sorted), a lookup that
    inserts misses with the meta write deferred to the optimizer; the
    unique rows become leaf tensors; one backward through the model and the
    loss; the dense optimizer (``state.opt_state``) steps; then
    ``sparse_opt.apply`` updates each table in place with the 1-indexed
    step and the lookup's payload and meta rows. ``dense_tx`` is accepted
    for the JAX signature: the dense optimizer is the state's, built by
    :func:`init_state`. ``train=False`` serves: lookups that never insert,
    the model and the loss; the state comes back unchanged.
    """
    if train and (sparse_opt is None or sparse_lr is None):
        raise ValueError("train=True needs sparse_opt and sparse_lr")
    # the JAX reference runs its float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # models may alias several tables to one id stream
    alias = getattr(model, "id_alias", {})

    def lookups(state, batch):
        day = packing.current_day() % (1 << 13)
        looks = {}
        for name in sorted(state.tables):
            looks[name], _ = emb.lookup_unique(
                state.tables[name], batch["ids"][alias.get(name, name)],
                train=train, defer_meta=train, day=day)
        return looks

    def forward(state, batch, embs):
        dev = state.step.device
        preds = model.apply(state.dense, embs,
                            _features(batch.get("features"), dev))
        labels = torch.as_tensor(batch["labels"], device=dev)
        return model.loss(preds, labels), preds

    def serve(state: TrainState, batch):
        with torch.no_grad():
            looks = lookups(state, batch)
            loss, preds = forward(state, batch,
                                  {n: emb.gather(looks[n]) for n in looks})
        return state, loss, preds

    def train_step(state: TrainState, batch):
        looks = lookups(state, batch)
        names = sorted(looks)
        rows = {n: looks[n].rows.detach().requires_grad_() for n in names}
        loss, preds = forward(state, batch,
                              {n: emb.gather(looks[n], rows[n])
                               for n in names})
        params = list(state.dense.parameters())
        grads = torch.autograd.grad(loss, params + [rows[n] for n in names],
                                    allow_unused=True)
        # optax updates every leaf; a parameter the loss does not reach
        # gets a zero gradient, as in JAX. Each step replaces ``p.grad``,
        # so after a step it holds that step's gradient.
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.opt_state.step()
        step = state.step + 1
        with torch.no_grad():
            for n, g in zip(names, grads[len(params):]):
                look = looks[n]
                sparse_opt.apply(
                    state.tables[n], look.slot,
                    torch.zeros_like(rows[n]) if g is None else g,
                    lr=sparse_lr, step=step, payload_rows=look.payload_rows,
                    meta_rows=look.meta_rows)
        return (state._replace(step=step), loss.detach(), preds.detach())

    return train_step if train else serve


def _take(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def make_train_step_scan(model: SparseModel, sparse_opt, dense_tx=None, *,
                         sparse_lr: float) -> Callable:
    """``step(state, batches) -> (state, losses)``: K training steps over a
    batch tree whose leaves have a leading ``[K]`` axis, in one call (the
    JAX package's ``lax.scan`` form; a Python loop here)."""
    one = make_train_step(model, sparse_opt, dense_tx, sparse_lr=sparse_lr)

    def multi(state: TrainState, batches):
        losses = []
        for i in range(len(batches["labels"])):
            state, loss, _ = one(state, _take(batches, i))
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


def grow_if_needed(state: TrainState, incoming_per_table: int) -> TrainState:
    """Between-steps growth check for every table: a table that would pass
    the load factor with ``incoming_per_table`` more rows is replaced by a
    grown copy (:func:`kv.table.grow_to_fit`), which carries its optimizer
    slot columns with its rows. Returns ``state`` itself when nothing grew,
    else a new state whose ``tables`` dict holds the new tables: keep the
    returned state, not the old one's tables. The train step reads
    ``state.tables`` on every call, so it caches no table."""
    tables = dict(state.tables)
    changed = False
    for name, t in tables.items():
        if kvt.needs_grow(t, incoming_per_table):
            tables[name] = kvt.grow_to_fit(t, incoming_per_table)
            changed = True
    return state._replace(tables=tables) if changed else state
