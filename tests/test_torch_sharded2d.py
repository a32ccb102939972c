"""Port parity for 2D (row x col) table sharding (``parallel/sharded2d.py``)
on a 2 x 2 ``DeviceMesh`` of 4 CPU ranks, against the JAX package on a
2 x 2 mesh of the conftest's fake devices (the launcher of
test_torch_parallel.py).

Each rank (r, c) starts from JAX's shard (``convert.sharded_2d_from_numpy``)
and trains 3 GroupAdam steps with an l21 penalty through
:func:`for_col_axis`, whose group norm is all-reduced over the col group
(the port's ``norm_axis``), so that blacklist decisions span the column
shards; then an eval lookup, ``combine_col_shards`` and growth past the
wall between steps. Headers (the same on both col ranks of a row),
capacities and sizes bit for bit; rows and state within 2e-5 / 1e-4."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import (STATE_TOL, join, launch, load_shard,
                                 put_table, rank_main, same_shard,
                                 save_jax_table)

R, C = 2, 2
DIM = 8
BL = 16                               # ids per rank and step
L21 = 0.05


def train_ids(steps=3):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 200, R * C * BL).astype(np.int32)
            for _ in range(steps)]


def eval_ids():
    return np.random.RandomState(2).randint(0, 400, R * C * BL).astype(
        np.int32)


def fresh_ids(steps=4):
    return [np.arange(R * C * BL, dtype=np.int32) + 500 * (s + 1)
            for s in range(steps)]


def _mine(x, rank):
    n = len(x) // (R * C)
    return torch.from_numpy(x[rank * n:(rank + 1) * n])


def port_2d(rank, world, d, out):
    from tfplus_tpu_torch import train as ttrain
    from tfplus_tpu_torch.parallel import sharded2d as s2
    mesh = s2.make_mesh_2d(R, C, device_type="cpu")
    r, c = divmod(rank, C)
    opt = s2.for_col_axis(
        ttrain.GroupAdamOptimizer(l21_regularization_strength=L21), mesh)
    t = load_shard(d, "t2d", r, c)
    for s, ids in enumerate(train_ids(), start=1):
        rows, state, t = s2.sharded_lookup_2d(t, _mine(ids, rank),
                                              mesh=mesh, defer_meta=True)
        out[f"rows{s}"] = rows.numpy()
        t = s2.sharded_apply_grads_2d(opt, t, state, rows * 0.5 + 0.01,
                                      mesh=mesh, lr=0.1, step=s)
    put_table(out, "train", t)
    rows, _, t = s2.sharded_lookup_2d(t, _mine(eval_ids(), rank), mesh=mesh,
                                      train=False)
    out["eval"] = rows.numpy()
    full = s2.combine_col_shards(t, mesh)
    put_table(out, "combined", full)
    out["combined.pool"] = full.init_pool.numpy()
    out["sizes"] = np.asarray(s2.shard_sizes_2d(t, mesh))

    g = load_shard(d, "g2d", r, c)
    sgd = ttrain.GradientDescentOptimizer()
    for s, ids in enumerate(fresh_ids(), start=1):
        tabs, _ = s2.grow_sharded_2d_if_needed({"g": g}, mesh,
                                               incoming_per_shard=2 * BL)
        g = tabs["g"]
        out[f"grow.cap{s}"] = np.int64(g.capacity)
        rows, state, g = s2.sharded_lookup_2d(g, _mine(ids, rank), mesh=mesh,
                                              defer_meta=True)
        g = s2.sharded_apply_grads_2d(sgd, g, state, rows * 0.5, mesh=mesh,
                                      lr=0.1, step=s)
    put_table(out, "grow", g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded2d")
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from tfplus_tpu import train as jtrain
    from tfplus_tpu.parallel import sharded2d as s2
    mesh = s2.make_mesh_2d(R, C)
    place = s2.table_sharding_2d(mesh)
    gadam = jtrain.GroupAdamOptimizer(l21_regularization_strength=L21)
    sgd = jtrain.GradientDescentOptimizer()
    t = jax.device_put(s2.init_optimizer_sharded_2d(
        gadam, s2.create_sharded_2d(DIM, 256, R, C, seed=0)), place)
    g = jax.device_put(s2.create_sharded_2d(DIM, 64, R, C, seed=1), place)
    save_jax_table(d, "t2d", t)
    save_jax_table(d, "g2d", g)
    handle = launch(Path(__file__), R * C, d)

    both = P(("row", "col"))

    def step_fn(opt, train, tab, ids, s):
        rows, state, tab = s2.sharded_lookup_2d(tab, ids, train=train,
                                                defer_meta=train)
        if train:
            grads = rows * 0.5 + (0.01 if opt is gadam else 0.0)
            tab = s2.sharded_apply_grads_2d(s2.for_col_axis(opt), tab,
                                            state, grads, lr=0.1, step=s)
        return rows, tab

    def build(opt, tab, train=True):
        tspec = jax.tree_util.tree_map(lambda _: P("row", "col"), tab)
        return jax.jit(shard_map(
            functools.partial(step_fn, opt, train), mesh=mesh,
            in_specs=(tspec, both, P()), out_specs=(both, tspec),
            check_vma=False))

    jres = {"rows": []}
    step = build(gadam, t)
    for s, ids in enumerate(train_ids(), start=1):
        rows, t = step(t, ids, s)
        jres["rows"].append(np.asarray(rows))
    jres["train"] = jax.device_get(t)
    jres["eval"] = np.asarray(build(gadam, t, train=False)(t, eval_ids(),
                                                           0)[0])
    jres["combined"] = s2.combine_col_shards(t)
    jres["sizes"] = s2.shard_sizes_2d(t)
    jres["caps"] = []
    for s, ids in enumerate(fresh_ids(), start=1):
        tabs, _ = s2.grow_sharded_2d_if_needed({"g": g},
                                               incoming_per_shard=2 * BL,
                                               sharding=place)
        g = tabs["g"]
        jres["caps"].append(g.header.shape[-2] * 16)
        _, g = build(sgd, g)(g, ids, s)
    jres["grow"] = jax.device_get(g)
    return join(handle), jres


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def test_lookup_and_groupadam_norm_across_cols_match_jax(run):
    ranks, jres = run
    for s, rows in enumerate(jres["rows"], start=1):
        np.testing.assert_allclose(_cat(ranks, f"rows{s}"), rows,
                                   err_msg=f"step {s}", **STATE_TOL)
    np.testing.assert_allclose(_cat(ranks, "eval"), jres["eval"],
                               **STATE_TOL)
    blacklisted = 0
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, C)
        jt = jax_shard(jres["train"], i, j)
        same_shard(r, "train", jt, f"({i}, {j})")
        # headers in lockstep across the col ranks of a row
        np.testing.assert_array_equal(r["train.header"],
                                      ranks[i * C]["train.header"])
        meta = r["train.header"].reshape(-1, 4, 16)[:, 2].astype(np.uint32)
        blacklisted += int(((meta >> 29) & 1).sum())
    assert blacklisted > 0, "l21 blacklisted nothing: the norm is untested"


def test_combine_col_shards_matches_jax(run):
    ranks, jres = run
    for rank, r in enumerate(ranks):
        i = rank // C
        same_shard(r, "combined", jres["combined"][i], f"row {i}")
        np.testing.assert_array_equal(r["combined.pool"],
                                      np.asarray(jres["combined"][i]
                                                 .init_pool))
        np.testing.assert_array_equal(r["sizes"], jres["sizes"])


def test_growth_2d_matches_jax(run):
    ranks, jres = run
    for s, cap in enumerate(jres["caps"], start=1):
        assert {int(r[f"grow.cap{s}"]) for r in ranks} == {cap}, s
    assert jres["caps"][-1] > 64
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, C)
        same_shard(r, "grow", jax_shard(jres["grow"], i, j), f"({i}, {j})")


def jax_shard(host, i, j):
    import jax
    return jax.tree_util.tree_map(lambda x: x[i, j], host)


if __name__ == "__main__":
    rank_main([port_2d])
