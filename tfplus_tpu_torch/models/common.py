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
from ..kv import hashing, multi as kvm, table as kvt, unique as kvu
from ..utils import device as _dev
from ..utils import packing, profiling


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


def _dim_groups(model: SparseModel) -> Dict[int, list]:
    """Logical tables grouped by embedding dim, in sorted name order (the
    groups in the order of their first name), for multi-table packing."""
    groups: Dict[int, list] = {}
    for name, spec in sorted(model.table_specs.items()):
        groups.setdefault(spec["dim"], []).append(name)
    return groups


def init_state_multi(model: SparseModel, sparse_opt, dense_tx=None, *,
                     seed: int = 0, capacity_per_group: int = 1 << 16,
                     device="cuda") -> TrainState:
    """Multi-table variant of :func:`init_state`: ALL logical tables of one
    embedding dim share ONE physical table ``tables["__group_<dim>"]``
    (``kv/multi.py``), so a 26-table DCN step becomes 2 probe, gather and
    apply passes instead of 26. Each group's table is created with
    ``capacity_per_group`` rows, ``name="multi_dim<dim>"`` and seed
    ``seed + dim``, then given ``sparse_opt``'s slots."""
    dev = _dev.resolve(device)
    dense = model.init_dense(torch.Generator().manual_seed(seed), dev)
    tables = {}
    for dim in _dim_groups(model):
        t = kvt.create(dim, capacity_per_group, name=f"multi_dim{dim}",
                       seed=seed + dim, device=dev)
        tables[f"__group_{dim}"] = sparse_opt.init(t)
    return TrainState(tables=tables, dense=dense,
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

    def serve(state: TrainState, batch):
        with profiling.annotate("tfp::step"), torch.no_grad():
            looks = lookups(state, batch)
            loss, preds = _forward(model, state, batch, lambda: {
                n: emb.gather(looks[n]) for n in looks})
        return state, loss, preds

    def train_step(state: TrainState, batch):
        with profiling.annotate("tfp::step"):
            looks = lookups(state, batch)
            names = sorted(looks)
            rows = {n: looks[n].rows.detach().requires_grad_()
                    for n in names}
            loss, preds = _forward(model, state, batch, lambda: {
                n: emb.gather(looks[n], rows[n]) for n in names})
            return _update(state, sparse_opt, sparse_lr, loss, preds, rows,
                           looks)

    return train_step if train else serve


def _forward(model: SparseModel, state: TrainState, batch, embs):
    """``(loss, preds)`` in a ``tfp::forward`` span: ``embs()`` (the take of
    the looked-up rows to the batch), the towers and the loss, with the
    features and labels fed in a ``tfp::feed`` span."""
    dev = state.step.device
    with profiling.annotate("tfp::forward"):
        with profiling.annotate("tfp::feed"):
            features = _features(batch.get("features"), dev)
            labels = torch.as_tensor(batch["labels"], device=dev)
        preds = model.apply(state.dense, embs(), features)
        return model.loss(preds, labels), preds


def _update(state: TrainState, sparse_opt, sparse_lr, loss, preds, rows,
            looks):
    """One backward, the dense optimizer's step, then ``sparse_opt.apply``
    on each table ``n`` of ``rows`` (the leaf tensors the lookups gave)
    with the 1-indexed step and the lookup's payload and meta rows."""
    names = list(rows)
    params = list(state.dense.parameters())
    with profiling.annotate("tfp::backward"):
        grads = torch.autograd.grad(loss, params + [rows[n] for n in names],
                                    allow_unused=True)
    # optax updates every leaf; a parameter the loss does not reach gets a
    # zero gradient, as in JAX. Each step replaces ``p.grad``, so after a
    # step it holds that step's gradient.
    with profiling.annotate("tfp::dense_opt"):
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


def make_train_step_multi(model: SparseModel, sparse_opt=None, dense_tx=None,
                          *, sparse_lr: Optional[float] = None,
                          train: bool = True) -> Callable:
    """``step(state, batch) -> (state, loss, preds)`` over the dim-grouped
    tables of :func:`init_state_multi`, with :func:`make_train_step`'s
    batch format and arguments.

    Dedup runs per logical table; each table's unique keys (pad rows masked
    out BEFORE tagging, which would make them ordinary keys) are tagged with
    its index in the group and concatenated, so each group's probe, gather,
    insert and optimizer apply run once over disjoint keys. Each logical
    table's rows are ``flat[j*B:(j+1)*B]`` of the group's rows (``B`` the
    batch size: ``unique_with_counts`` pads its output to it), expanded to
    the batch through ``embedding.gather``'s take, whose backward sums
    duplicates in a fixed order. Serving (``train=False``) runs ``find``
    and a gather of the found rows per group.
    """
    if train and (sparse_opt is None or sparse_lr is None):
        raise ValueError("train=True needs sparse_opt and sparse_lr")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    alias = getattr(model, "id_alias", {})
    groups = {f"__group_{dim}": names
              for dim, names in _dim_groups(model).items()}

    def lookups(state: TrainState, batch):
        day = packing.current_day() % (1 << 13)
        looks, parts = {}, {}
        for key, names in groups.items():
            table = state.tables[key]
            uniqs, tagged, counts, valids = [], [], [], []
            for j, name in enumerate(names):
                enc = emb._canon_ids(batch["ids"][alias.get(name, name)],
                                     table.device)
                u = kvu.unique_with_counts(enc)
                uniqs.append(u)
                valids.append(~hashing.is_empty(u.unique_keys))
                tagged.append(kvm.tag_ids(u.unique_keys, j))
                counts.append(u.counts)
            all_ids = torch.cat(tagged)
            all_valid = torch.cat(valids)
            all_counts = torch.cat(counts)
            if train:
                res = kvt.lookup_or_insert(table, all_ids, counts=all_counts,
                                           valid=all_valid, defer_meta=True,
                                           day=day)
                looks[key] = emb.Lookup(
                    rows=res.rows, slot=res.slot, inverse=None,
                    counts=all_counts, valid=all_valid, num_unique=None,
                    payload_rows=res.payload_rows, meta_rows=res.meta_rows)
            else:
                fr = kvt.find(table, all_ids, all_valid)
                looks[key] = emb.Lookup(
                    rows=kvt._gather_rows(table, fr.slot, fr.found, fr.meta),
                    slot=torch.where(fr.found, fr.slot, -1), inverse=None,
                    counts=all_counts, valid=all_valid, num_unique=None)
            parts[key] = uniqs
        return looks, parts

    def expand(parts, rows):
        embs = {}
        for key, uniqs in parts.items():
            flat = rows[key]
            bs = uniqs[0].inverse.shape[0]
            for j, name in enumerate(groups[key]):
                embs[name] = emb._TakeRows.apply(
                    flat[j * bs:(j + 1) * bs], uniqs[j].inverse.long())
        return embs

    def serve(state: TrainState, batch):
        with profiling.annotate("tfp::step"), torch.no_grad():
            looks, parts = lookups(state, batch)
            loss, preds = _forward(model, state, batch, lambda: expand(
                parts, {k: look.rows for k, look in looks.items()}))
        return state, loss, preds

    def train_step(state: TrainState, batch):
        with profiling.annotate("tfp::step"):
            looks, parts = lookups(state, batch)
            rows = {k: look.rows.detach().requires_grad_()
                    for k, look in looks.items()}
            loss, preds = _forward(model, state, batch,
                                   lambda: expand(parts, rows))
            return _update(state, sparse_opt, sparse_lr, loss, preds, rows,
                           looks)

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
