"""Port parity for the DLRM, DeepFM, Wide&Deep and NCF models at one tiny
shape each: from the same tables (carried across with ``to_port``) and the
same dense weights (loaded with ``convert.dense_from_numpy``), the port's
serving step gives JAX's predictions and loss, and autograd the same dense
gradients as ``jax.grad`` of the JAX model's loss. JAX's train step is not
run here: the training machinery is held against JAX in
``test_torch_train.py``; one port training step per model shows the models
train (DeepFM's and Wide&Deep's dim-1 tables read through ``id_alias``).

Tolerances: ``atol = rtol = 1e-5`` for predictions, losses and gradients
(float32 with another summation order in the matmuls, and DLRM's ``bmm``
against ``einsum``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import kv as jkv
from tfplus_tpu import models as jmodels
from tfplus_tpu_torch import convert, models as tmodels
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import train as ttrain
from test_torch_table import jax_init_dense, to_port
from test_torch_train import _flat

BATCH = 16
TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = {
    "DLRM": dict(num_tables=3, embedding_dim=4, num_numeric=5,
                 bottom_hidden=(8, 4), top_hidden=(8,), capacity=64),
    "DeepFM": dict(num_fields=3, embedding_dim=4, num_numeric=5,
                   dnn_hidden=(8, 6), capacity=64),
    "WideDeep": dict(num_fields=3, embedding_dim=4, num_numeric=5,
                     dnn_hidden=(8, 6), capacity=64),
    "NCF": dict(embedding_dim=4, hidden=(8, 6), capacity=64),
}


def _setup(name, rng):
    """JAX and port models, JAX tables with rows for ids 1..40 and their
    port copies, JAX dense params and the port's copy, and a batch."""
    jmodel = getattr(jmodels, name)(**CONFIGS[name])
    tmodel = getattr(tmodels, name)(**CONFIGS[name])
    alias = getattr(jmodel, "id_alias", {})
    assert getattr(tmodel, "id_alias", {}) == alias
    assert tmodel.table_specs == jmodel.table_specs
    universe = np.arange(1, 41, dtype=np.int64)
    jtables = {}
    for i, (n, spec) in enumerate(sorted(jmodel.table_specs.items())):
        t = jkv.create(spec["dim"], spec["capacity"], init_pool_rows=10,
                       seed=i)
        rows = rng.randn(len(universe), spec["dim"]).astype(np.float32)
        jtables[n] = jkv.insert(t, jkv.encode_ids_np_to_device(universe),
                                jnp.asarray(rows), day=3)
    jdense = jax.device_get(jax_init_dense(jmodel, 0))
    tdense = tmodel.init_dense(torch.Generator().manual_seed(1), "cpu")
    convert.dense_from_numpy(tdense, jdense)
    streams = sorted({alias.get(n, n) for n in jmodel.table_specs})
    batch = {"ids": {s: rng.randint(1, 50, BATCH).astype(np.int64)
                     for s in streams},
             "labels": (rng.randint(0, 2, BATCH) if name != "NCF"
                        else rng.rand(BATCH) * 5).astype(np.float32)}
    if name != "NCF":
        batch["features"] = rng.randn(BATCH, 5).astype(np.float32)
    tstate = tmodels.TrainState(
        tables={n: to_port(t) for n, t in jtables.items()}, dense=tdense,
        opt_state=None, step=torch.zeros((), dtype=torch.int32))
    return jmodel, tmodel, jtables, jdense, tstate, batch


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_jax(name):
    rng = np.random.RandomState(len(name))
    jmodel, tmodel, jtables, jdense, tstate, batch = _setup(name, rng)
    alias = getattr(jmodel, "id_alias", {})
    jembs = {n: jkv.lookup_or_zeros(t, jkv.encode_ids_np_to_device(
        batch["ids"][alias.get(n, n)])) for n, t in jtables.items()}
    feats = (jnp.asarray(batch["features"]) if "features" in batch
             else None)

    @functools.partial(jax.value_and_grad, has_aux=True)
    def jloss(dense):
        preds = jmodel.apply(dense, jembs, feats)
        return jmodel.loss(preds, jnp.asarray(batch["labels"])), preds

    (jl, jpreds), jgrads = jax.jit(jloss)(jdense)

    _, tl, tpreds = tmodels.make_train_step(tmodel, train=False)(tstate,
                                                                batch)
    np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    # dense gradients through autograd, from the same embeddings
    tembs = {n: tkv.lookup_or_zeros(t, tkv.encode_ids_np_to_device(
        batch["ids"][alias.get(n, n)], "cpu"))
        for n, t in tstate.tables.items()}
    ft = (torch.from_numpy(batch["features"]) if "features" in batch
          else None)
    loss = tmodel.loss(tmodel.apply(tstate.dense, tembs, ft),
                       torch.from_numpy(batch["labels"]))
    loss.backward()
    want = _flat(jax.device_get(jgrads))
    got = {k: p.grad.numpy() for k, p in tstate.dense.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

    # one port training step from empty tables: every table (the dim-1
    # ones through their alias) inserts its stream's ids
    opt = ttrain.AdamOptimizer()
    state = tmodels.init_state(tmodel, opt,
                               functools.partial(torch.optim.Adam, lr=1e-3),
                               device="cpu")
    step = tmodels.make_train_step(tmodel, opt, sparse_lr=1e-3)
    state, loss, preds = step(state, batch)
    assert preds.shape == (BATCH,) and bool(torch.isfinite(loss))
    for n, t in state.tables.items():
        ids = np.unique(batch["ids"][alias.get(n, n)])
        assert int(tkv.size(t)) == len(ids), n
