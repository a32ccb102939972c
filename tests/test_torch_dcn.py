"""Port parity for the serving slice as a whole: a small DCN trained two steps
in JAX, carried across with convert.py, serves the same predictions and loss
from the port's ``make_train_step(train=False)``; ``partitioned_lookup``
over a 3-shard list matches too.

Tolerance for preds and loss: float32 with a different summation order in
the matmuls on each side, so ``atol = rtol = 1e-5``. Table lookups are
copies and must match bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import embedding as jemb, kv as jkv, models as jmodels
from tfplus_tpu import train as tft
from tfplus_tpu_torch import convert, embedding as temb, models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu_torch.nn import layers as tlayers
from test_torch_table import (assert_same, assert_same_table, jax_init_state,
                              to_port)

DIMS = (8, 8, 8)
NUM_NUMERIC = 5
BATCH = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(rng, universe):
    ids = {f"C{i+1}": rng.choice(universe, BATCH).astype(np.int32)
           for i in range(len(DIMS))}
    return {"ids": ids,
            "features": rng.randn(BATCH, NUM_NUMERIC).astype(np.float32),
            "labels": rng.randint(0, 2, BATCH).astype(np.float32)}


def _jax_batch(b):
    return {"ids": {k: jnp.asarray(v) for k, v in b["ids"].items()},
            "features": jnp.asarray(b["features"]),
            "labels": jnp.asarray(b["labels"])}


def _models():
    kw = dict(embedding_dims=DIMS, num_numeric=NUM_NUMERIC, dnn_hidden=(16, 8),
              capacity=256)
    return jmodels.DCN(**kw), tmodels.DCN(**kw)


def test_dcn_serving_matches_jax():
    rng = np.random.RandomState(0)
    universe = rng.randint(0, 10_000, 80)
    jmodel, tmodel = _models()
    opt = tft.AdagradOptimizer(learning_rate=0.05)
    tx = optax.adam(0.01)
    state = jax_init_state(jmodel, opt, tx, seed=0)
    step = jmodels.make_train_step(jmodel, opt, tx, sparse_lr=0.05)
    for _ in range(2):
        state, _, _ = step(state, _jax_batch(_batch(rng, universe)))
    estep = jmodels.make_train_step(jmodel, opt, tx, sparse_lr=0.05,
                                    train=False, donate=False)
    # eval ids: trained ones plus ids no table has seen
    eb = _batch(rng, np.concatenate([universe, universe + 20_000]))
    _, jloss, jpreds = estep(state, _jax_batch(eb))

    tables = {n: to_port(t) for n, t in state.tables.items()}
    dense = tmodel.init_dense(torch.Generator().manual_seed(1), "cpu")
    convert.dense_from_numpy(dense, jax.device_get(state.dense))
    tstate = tmodels.TrainState(tables=tables, dense=dense, opt_state=None,
                                step=torch.zeros((), dtype=torch.int32))
    tstep = tmodels.make_train_step(tmodel, train=False)
    out_state, tloss, tpreds = tstep(tstate, eb)
    assert out_state is tstate
    assert tpreds.shape == (BATCH,) and torch.isfinite(tpreds).all()
    np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    # serving never mutates the tables
    for n in tables:
        assert_same_table(state.tables[n], tables[n])


def test_partitioned_lookup_matches_jax():
    rng = np.random.RandomState(1)
    jshards = [jkv.create(8, 256, seed=s) for s in range(3)]
    tshards = [to_port(t) for t in jshards]
    ids = rng.randint(-50, 2**31 - 1, 48).astype(np.int64)
    ids[:4] = ids[4:8]                               # duplicates
    jrows, jshards = jemb.partitioned_lookup(jshards, ids, train=True, day=9)
    trows, tshards = temb.partitioned_lookup(tshards, ids, train=True, day=9)
    assert_same(jrows, trows)
    for jt, tt in zip(jshards, tshards):
        assert_same_table(jt, tt)
    q = np.concatenate([ids[:20], rng.randint(0, 2**31 - 1, 12)])
    jrows, _ = jemb.partitioned_lookup(jshards, q, train=False)
    trows, _ = temb.partitioned_lookup(tshards, q, train=False)
    assert_same(jrows, trows)
    # a single table takes the plain embedding_lookup path
    jrows, _ = jemb.partitioned_lookup(jshards[0], q.reshape(4, 8), train=False)
    trows, _ = temb.partitioned_lookup(tshards[0], q.reshape(4, 8), train=False)
    assert trows.shape == (4, 8, 8)
    assert_same(jrows, trows)


def test_lookup_unique_train_matches_jax():
    rng = np.random.RandomState(2)
    jt = jkv.create(8, 256, seed=4)
    tt = to_port(jt)
    ids = rng.randint(0, 60, 40).astype(np.int32)
    valid = rng.rand(40) < 0.8
    jl, jt = jemb.lookup_unique(jt, ids, valid=jnp.asarray(valid), day=3,
                                defer_meta=True)
    tl, tt = temb.lookup_unique(tt, ids, valid=torch.from_numpy(valid), day=3,
                                defer_meta=True)
    for f in ("rows", "slot", "inverse", "counts", "valid", "num_unique",
              "payload_rows", "meta_rows"):
        assert_same(getattr(jl, f), getattr(tl, f), f)
    assert_same(jemb.gather(jl), temb.gather(tl))
    assert_same_table(jt, tt)


def test_training_is_a_later_slice():
    """``train=True`` trains: tables get the optimizer's slot columns, the
    step counts, repeated steps on one batch lower the loss, and serving
    after training reads the trained rows."""
    _, tmodel = _models()
    opt = ttrain.GroupAdamOptimizer()
    state = tmodels.init_state(tmodel, opt,
                               functools.partial(torch.optim.Adam, lr=1e-2),
                               seed=3, device="cpu")
    assert sorted(state.tables) == ["C1", "C2", "C3"]
    assert state.tables["C1"].capacity == 256
    assert state.tables["C1"].payload.shape == (256, 4 * 8)
    rng = np.random.RandomState(3)
    batch = _batch(rng, np.arange(100))
    step = tmodels.make_train_step(tmodel, opt, sparse_lr=0.05)
    losses = []
    for _ in range(5):
        state, loss, preds = step(state, batch)
        losses.append(float(loss))
    assert preds.shape == (BATCH,) and int(state.step) == 5
    assert losses[-1] < losses[0]
    _, loss, _ = tmodels.make_train_step(tmodel, train=False)(state, batch)
    assert float(loss) < losses[0]


@pytest.mark.parametrize("make", [
    lambda **kw: tlayers.Dense(4, 2, **kw),
    lambda **kw: tlayers.MLP(4, (3, 2), **kw),
    lambda **kw: tlayers.CrossNet(4, 2, **kw),
], ids=["Dense", "MLP", "CrossNet"])
def test_layers_default_to_the_card(make):
    assert all(p.device.type == "cpu" for p in make(device="cpu").parameters())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make()
