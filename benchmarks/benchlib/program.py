"""The system under test, a sparse model of ``tfplus_tpu_torch``, built for
one cell: its tables filled with the seed's ids and rows, its dense towers
given the seed's weights, and the step the window drives. Also what the
reference needs to work the tables out again, and the counts of work
(operations, row bytes) that the per-layer metrics divide by times.

The cell's adapter (``models/<config>.py``) says how to build the model and
compose its batches, and a cell over several ranks takes its step from the
adapter's ``make_step``; everything else here is common to sparse models.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from reference import sparse as ref_sparse

from . import inputs, peaks
from .traffic import Traffic


def _check_world(adapter, mix: dict, train: bool, size: int) -> None:
    """What a cell over ``size`` ranks needs before anything is built."""
    if not train:
        raise ValueError(f"serving over {size} ranks is not supported: "
                         "no cell asks for it")
    if not hasattr(adapter, "make_step"):
        raise ValueError(f"a cell over {size} ranks needs its adapter's "
                         "make_step(tp, model, opt, sparse_lr, group)")
    if mix["batch"] % size:
        raise ValueError(f"the global batch {mix['batch']} does not divide "
                         f"over {size} ranks")


def _kwargs(rule, spec: dict) -> dict:
    """The keyword arguments of ``rule``'s constructor from the
    configuration's optimizer entry ``spec``."""
    return {kw: spec[key] for kw, key in rule.args}


class SparseProgram:
    """One cell's program: ``state``, ``step`` and ``traffic``.

    With ``world`` (a :class:`benchlib.ranks.World`) the program is this
    rank's part of a cell over several ranks, one process per card: each
    table is this rank's shard (``parallel.create_sharded``, a table's
    ``capacity`` over the ranks), filled with the resident ids it owns, and
    the step is the adapter's ``make_step(tp, model, opt, sparse_lr,
    group)``, which takes this rank's slice of each global batch."""

    world = None

    def __init__(self, adapter, cfg: dict, mix: dict, seed: int, device,
                 world=None):
        import tfplus_tpu_torch as tp
        self.tp = tp
        self.adapter, self.cfg, self.mix = adapter, cfg, mix
        self.seed, self.device = seed, torch.device(device)
        self.world = world
        self.train = mix["loop"] == "train"
        self.chunked = cfg.get("row_draw") == "chunked"
        sparse = cfg["sparse_optimizer"]
        if self.train:       # the rules' table: reference.sparse.RULES
            self.rule = ref_sparse.rule(sparse)
            self.dense_rule = ref_sparse.rule(cfg["dense_optimizer"],
                                              dense=True)
        if world is not None:
            _check_world(adapter, mix, self.train, world.size)
        self.tables = adapter.tables(cfg)          # name -> (dim, rows, keys)
        self.model = model = adapter.make_model(cfg, tp.models)
        for name, spec in model.table_specs.items():
            spec["initializer"] = inputs.init_pool(seed, name, spec["dim"],
                                                   self.device)
        self.opt, dense_tx = None, None
        if self.train:
            self.opt = getattr(tp.train, self.rule.port)(
                **_kwargs(self.rule, sparse))
            dense_tx = functools.partial(
                getattr(torch.optim, self.dense_rule.port),
                **_kwargs(self.dense_rule, cfg["dense_optimizer"]))
        self.state = (tp.models.init_state(model, self.opt, dense_tx,
                                           device=self.device)
                      if world is None else self._sharded_state(dense_tx))
        self.weights = inputs.dense_weights(seed, adapter.dense_spec(cfg),
                                            self.device)
        self.state.dense.load_state_dict(self.weights, strict=True)
        self.unplaced = {name: self._fill(name)
                         for name in sorted(self.tables)}
        if world is not None:
            self.unplaced = dict(zip(self.unplaced, world.sum(
                list(self.unplaced.values()))))
            step = adapter.make_step(tp, model, self.opt, sparse["lr"],
                                     world.group)
            self.step = lambda state, batch: step(state, self.local(batch))
        elif self.train:
            self.step = tp.models.make_train_step(model, self.opt,
                                                  sparse_lr=sparse["lr"])
        else:
            self.step = tp.models.make_train_step(model, train=False)
        self.traffic = Traffic(mix, {n: t[2] for n, t in self.tables.items()},
                               seed, self.device)
        self.traffic.fill(functools.partial(adapter.draw, cfg=cfg))

    def _sharded_state(self, dense_tx):
        """A training state whose tables are this rank's shards, with the
        optimizer's slots; the dense towers are whole on every rank."""
        par, world = self.tp.parallel, self.world
        tables = {}
        for i, (name, spec) in enumerate(sorted(
                self.model.table_specs.items())):
            spec = dict(spec)
            dim, capacity = spec.pop("dim"), spec.pop("capacity")
            spec.setdefault("name", name)
            shard = par.create_sharded(dim, capacity // world.size,
                                       world.group, device=self.device,
                                       seed=i, **spec)
            tables[name] = par.init_optimizer_sharded(self.opt, shard)
        dense = self.model.init_dense(torch.Generator().manual_seed(0),
                                      self.device)
        return self.tp.models.TrainState(
            tables=tables, dense=dense, opt_state=dense_tx(dense.parameters()),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def _fill(self, name: str) -> int:
        """Insert the table's resident ids with their rows (in a world of
        several ranks, those this rank's shard owns); returns how many the
        table did not place (an id whose two buckets are full). The traffic
        draws from all of them: an id left out reads as zeros, which the
        reference does not, and the run is not correct."""
        dim, _, n = self.tables[name]
        kv = self.tp.kv
        table = self.state.tables[name]
        step = inputs.ROW_CHUNK if self.chunked else max(n, 1)
        keys = []
        for lo in range(0, n, step):
            idx = torch.arange(lo, min(n, lo + step), device=self.device)
            q = inputs.encode(inputs.key_of(idx, self.seed, name))
            rows = (inputs.chunk_rows(self.seed, name, lo // step, n, dim,
                                      self.device) if self.chunked else
                    inputs.table_rows(self.seed, name, n, dim, self.device))
            if self.world is not None:
                own = kv.hashing.shard_of(q, self.world.size) \
                    == self.world.rank
                q, rows = q[own], rows[own]
            kv.insert(table, q, rows, day=1)
            del rows        # not held through the finds: the peak stays put
            keys.append(q)
        return sum(int((~kv.find(table, q).found).sum()) for q in keys)

    def local(self, b: dict) -> dict:
        """This rank's slice of a global batch: examples ``[r·B/N,
        (r+1)·B/N)`` of every array (the whole batch in a world of one)."""
        if self.world is None:
            return b
        per_rank = self.mix["batch"] // self.world.size
        lo = self.world.rank * per_rank

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            width = x.shape[0] // self.mix["batch"]
            return x[lo * width:(lo + per_rank) * width]
        return {"ids": cut(b["ids"]), "features": cut(b["features"]),
                "labels": cut(b["labels"])}

    def _owner(self, ids: np.ndarray) -> np.ndarray:
        """The rank whose shards own each id, by the port's own routing
        (``kv.hashing.shard_of``), as ``_fill`` placed them."""
        q = inputs.encode(torch.from_numpy(ids).to(self.device))
        return self.tp.kv.hashing.shard_of(q, self.world.size).cpu().numpy()

    def _mine(self, ids: np.ndarray) -> np.ndarray:
        """The ids this rank's shards own."""
        if self.world is None:
            return ids
        return ids[self._owner(ids) == self.world.rank]

    # training readings -----------------------------------------------------
    def _rows(self, name: str, ids: np.ndarray, first: int, width: int):
        """Columns ``first:first + width`` of the rows of ``ids`` as the
        table holds them (NaN for an id it does not hold), on the host in
        the table's type."""
        table = self.state.tables[name]
        q = inputs.encode(torch.from_numpy(ids).to(self.device))
        fr = self.tp.kv.find(table, q)
        rows = table.payload[fr.slot.long().clamp(min=0), first:first + width]
        return torch.where(fr.found[:, None], rows,
                           torch.full_like(rows, float("nan"))).cpu()

    def check_steps(self, n: int):
        """Steps ``0..n-1`` of the run through the window's own call and
        feed, with what the reference compares: each step's loss, the first
        gradient per leaf as the optimizers leave it after step 1 (read as
        the rule's ``first_grad`` says: Adam's first moment over ``1 -
        beta1``, or SGD's step, (seeded value - value after step 1) / lr),
        and each leaf after step ``n``. Table leaves cover the ids the
        steps touched, sorted.

        In a world of several ranks the readings are gathered to rank 0
        (the others get None): the loss is the mean of the ranks' slices'
        losses, the dense leaves are rank 0's (the step all-reduces their
        gradients), and each id's row is read from the shard that owns it."""
        batches = [self.traffic.batch(s) for s in range(n)]
        touched = {name: np.unique(np.concatenate(
            [b["ids"][name] for b in batches])) for name in self.tables}
        first = {name: np.unique(batches[0]["ids"][name])
                 for name in self.tables}
        out = {"losses": [], "grads": {}, "final": {}}
        grads, final = {}, {}
        for s, b in enumerate(batches):
            self.state, loss, _ = self.step(self.state, self.traffic.feed(b))
            out["losses"].append(float(loss))
            if s == 0:
                out["grads"] = self._dense_first_grads()
                for name in self.tables:
                    start = 0           # "step": the rows themselves
                    if self.rule.first_grad == "moment":
                        start, _ = self.state.tables[
                            name].config.slot_columns()[self.opt.slot_name]
                    grads[name] = self._rows(name, self._mine(first[name]),
                                             start, self.tables[name][0])
        for pname, p in self.state.dense.named_parameters():
            out["final"][pname] = p.detach().double().cpu()
        for name in self.tables:
            final[name] = self._rows(name, self._mine(touched[name]), 0,
                                     self.tables[name][0])
        if self.world is not None:
            parts = self.world.gather((out["losses"], grads, final))
            if parts is None:
                return None
            out["losses"] = [float(np.mean(x)) for x in zip(
                *(p[0] for p in parts))]
            grads = {name: self._assemble(first[name], [p[1][name]
                                                        for p in parts])
                     for name in self.tables}
            final = {name: self._assemble(touched[name], [p[2][name]
                                                          for p in parts])
                     for name in self.tables}
        sparse = self.cfg["sparse_optimizer"]
        for name in self.tables:
            if self.rule.first_grad == "moment":
                g = grads[name].double() / (1 - sparse["b1"])
            else:
                seeded = self.row_source("fresh")(name, first[name]).cpu()
                g = (seeded - grads[name].double()) / sparse["lr"]
            out["grads"][f"table:{name}"] = g
            out["final"][f"table:{name}"] = final[name].double()
        return out

    def _dense_first_grads(self) -> dict:
        """Each dense leaf's first gradient, read after step 1 as its rule
        says (Adam: NaN for a leaf it did not step)."""
        opt = self.state.opt_state
        lr = self.cfg["dense_optimizer"]["lr"]
        out = {}
        for pname, p in self.state.dense.named_parameters():
            if self.dense_rule.first_grad == "moment":
                m = opt.state.get(p, {}).get("exp_avg")
                beta = opt.param_groups[0]["betas"][0]
                out[pname] = (
                    torch.full(p.shape, float("nan"), dtype=torch.float64)
                    if m is None else m.double().cpu() / (1 - beta))
            else:
                out[pname] = (self.weights[pname].double().cpu()
                              - p.detach().double().cpu()) / lr
        return out

    def _assemble(self, ids: np.ndarray, parts: list) -> torch.Tensor:
        """The rows of ``ids`` from each rank's part, ``parts[r]`` holding
        the rows of the ids rank ``r`` owns, in order."""
        out = parts[0].new_full((ids.shape[0], parts[0].shape[1]),
                                float("nan"))
        owner = self._owner(ids)
        for r, rows in enumerate(parts):
            out[torch.from_numpy(owner == r)] = rows
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # what the reference is handed -------------------------------------------
    def row_source(self, missing: str):
        """``rows(table, ids) -> float64 rows`` of the seed's tables: a
        resident id's row; any other id ``"fresh"``'s pool row or
        ``"zero"``. The resident rows are drawn again, once per table, or
        in a chunked table only the chunks that hold the ids asked for."""
        cache = {}

        def rows(name, ids):
            dim, _, n = self.tables[name]
            if name not in cache and not self.chunked:
                cache[name] = inputs.table_rows(self.seed, name, n, dim,
                                                self.device)
            t = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(
                self.device)
            idx, res = inputs.index_of(t, self.seed, name, n)
            if self.chunked:
                out = inputs.rows_at(self.seed, name, torch.where(res, idx, 0),
                                     n, dim, self.device).double()
            else:
                out = cache[name][idx].double()
            if missing == "fresh":
                other = ref_sparse.fresh_rows(
                    t, inputs.init_pool(self.seed, name, dim, self.device))
            else:
                other = torch.zeros_like(out)
            return torch.where(res[:, None], out, other)

        return rows

    # counts of work --------------------------------------------------------
    def rows_bytes(self, batch: dict) -> float:
        """Bytes the row kernels must move for one step or request of
        ``batch``: each row gathered is read once and written once, and so
        is each row scattered, with its 4-byte index. Training gathers every
        unique id's payload and slot row, scatters the fresh ids' initial
        rows and the optimizer's updated rows; serving gathers the resident
        ids' embedding rows. In a world of several ranks: the rows of the
        ids this rank's shards own, which its kernels move for the whole
        global ``batch``."""
        total = 0.0
        for name, ids in batch["ids"].items():
            dim = self.tables[name][0]
            uniq = self._mine(np.unique(ids))
            if self.train:
                width = dim * (1 + ref_sparse.rule(
                    self.cfg["sparse_optimizer"]).width)
                fresh = int((uniq >= inputs.FRESH_BASE).sum())
                rows = 2 * uniq.shape[0] + fresh
            else:
                width = dim
                rows = int(((uniq >= inputs.SPAN)
                            & (uniq < 2 * inputs.SPAN)).sum())
            total += rows * (2 * width * 4 + 4)
        return total

    def model_flops(self, batch: dict) -> float:
        fwd = self.adapter.forward_flops(batch, self.cfg)
        return 3 * fwd if self.train else fwd

    def attention_bound_s(self, batch: dict):
        """Least time of the attention kernels for ``batch`` (forward, and
        in training the backward), or None for a model without attention:
        the larger of the valid (row, key) pairs' operations over the
        float32 peak and the valid rows' bytes over the HBM rate. The
        forward needs 4·D operations a pair and reads q, k, v and writes the
        output (and, in training, l and m) of each valid row; the backward
        10·D (s again, dp, dq, dk, dv) and reads q, k, v, do, l, m, di and
        writes dq, dk, dv."""
        work = self.adapter.attention_work(batch, self.cfg)
        if work is None:
            return None
        # rows and pairs are counted per head
        pairs, rows, hd = work["pairs"], work["rows"], work["head_dim"]
        esz = 4
        t = max(4 * hd * pairs / peaks.FLOPS["float32"],
                (4 * rows * hd * esz + (8 * rows if self.train else 0))
                / peaks.HBM_BYTES_PER_S)
        if self.train:
            t += max(10 * hd * pairs / peaks.FLOPS["float32"],
                     (7 * rows * hd * esz + 12 * rows)
                     / peaks.HBM_BYTES_PER_S)
        return t
