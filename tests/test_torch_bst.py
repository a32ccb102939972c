"""Port parity for BST and DIN serving: a small model trained two steps in
JAX, carried across with convert.py (tables through ``to_port``, dense
weights through ``dense_from_numpy``), serves the same predictions and loss
from the port's ``make_train_step(train=False)``, on a batch with pad ids,
unknown ids and users with no history.

Tolerance for preds and loss: float32 with another summation order in the
matmuls, layer norms, softmaxes and (BST) the attention kernels' plain
versions against JAX's exact attention, so ``atol = rtol = 1e-5``. The
tables must come back untouched, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import models as jmodels
from tfplus_tpu import train as tft
from tfplus_tpu_torch import convert, models as tmodels
from test_torch_table import (assert_same_table, jax_init_dense,
                              jax_init_state, to_port)

BATCH = 16
HIST = 6
NUM_NUMERIC = 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _models(name):
    if name == "BST":
        kw = dict(embedding_dim=16, seq_len=HIST, num_numeric=NUM_NUMERIC,
                  num_heads=2, head_dim=8, num_blocks=2, ffn_hidden=32,
                  dnn_hidden=(16, 8), capacity=256)
    else:
        kw = dict(embedding_dim=8, seq_len=HIST, num_numeric=NUM_NUMERIC,
                  att_hidden=(12, 6), dnn_hidden=(16, 8), capacity=256)
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)


def _batch(model, rng, universe):
    """Histories of 0..HIST real items (pad id 0 behind them), one user with
    no history at all."""
    lengths = rng.randint(0, HIST + 1, BATCH)
    lengths[0] = 0
    mask = (np.arange(HIST)[None, :] < lengths[:, None]).astype(np.float32)
    seq = np.where(mask > 0, rng.choice(universe, (BATCH, HIST)), 0)
    cand = rng.choice(universe, BATCH)
    return {"ids": {"item": model.pack_item_ids(cand, seq).astype(np.int32),
                    "user": rng.choice(universe, BATCH).astype(np.int32)},
            "features": {"numeric": rng.randn(BATCH, NUM_NUMERIC)
                         .astype(np.float32), "mask": mask},
            "labels": rng.randint(0, 2, BATCH).astype(np.float32)}


def _jax_batch(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


@pytest.mark.parametrize("name", ["BST", "DIN"])
def test_serving_matches_jax(name):
    rng = np.random.RandomState(len(name))
    universe = rng.randint(1, 10_000, 60)
    jmodel, tmodel = _models(name)
    opt = tft.AdagradOptimizer(learning_rate=0.05)
    tx = optax.adam(0.01)
    state = jax_init_state(jmodel, opt, tx, seed=0)
    step = jmodels.make_train_step(jmodel, opt, tx, sparse_lr=0.05)
    for _ in range(2):
        state, _, _ = step(state, _jax_batch(_batch(jmodel, rng, universe)))
    estep = jmodels.make_train_step(jmodel, opt, tx, sparse_lr=0.05,
                                    train=False, donate=False)
    # eval ids: trained ones plus ids no table has seen
    eb = _batch(jmodel, rng, np.concatenate([universe, universe + 20_000]))
    _, jloss, jpreds = estep(state, _jax_batch(eb))

    tables = {n: to_port(t) for n, t in state.tables.items()}
    dense = tmodel.init_dense(torch.Generator().manual_seed(1), "cpu")
    convert.dense_from_numpy(dense, jax.device_get(state.dense))
    tstate = tmodels.TrainState(tables=tables, dense=dense, opt_state=None,
                                step=torch.zeros((), dtype=torch.int32))
    out_state, tloss, tpreds = tmodels.make_train_step(
        tmodel, train=False)(tstate, eb)
    assert out_state is tstate
    assert tpreds.shape == (BATCH,) and torch.isfinite(tpreds).all()
    np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for n in tables:
        assert_same_table(state.tables[n], tables[n])


def test_features_dict_passes_through():
    """The serving step hands a features dict to the model as a dict of
    float32 tensors on the state's device (an array stays one tensor)."""
    seen = []

    class Probe(tmodels.DCN):
        def apply(self, dense, embeddings, features):
            seen.append(features)
            return torch.zeros(BATCH)

    model = Probe(embedding_dims=(4,), num_numeric=0, dnn_hidden=(4,),
                  capacity=64)
    state = tmodels.init_state(model, seed=0, device="cpu")
    step = tmodels.make_train_step(model, train=False)
    ids = {"C1": np.arange(BATCH, dtype=np.int32)}
    labels = np.zeros(BATCH, np.float32)
    mask = np.ones((BATCH, 3), np.int64)
    step(state, {"ids": ids, "labels": labels,
                 "features": {"numeric": np.ones((BATCH, 2)), "mask": mask}})
    step(state, {"ids": ids, "labels": labels,
                 "features": np.ones((BATCH, 2), np.float64)})
    feats, arr = seen
    assert sorted(feats) == ["mask", "numeric"]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in feats.values())
    assert torch.equal(feats["mask"], torch.ones(BATCH, 3))
    assert isinstance(arr, torch.Tensor) and arr.dtype == torch.float32


@pytest.mark.parametrize("name,keys", [
    ("BST", {"pos", "blocks.0.qkv.w", "blocks.1.ln2.g", "dnn_logits.b"}),
    ("DIN", {"att.0.w", "att_out.b", "dnn.1.w", "dnn_logits.w"})])
def test_state_dict_names_follow_the_jax_pytree(name, keys):
    jmodel, tmodel = _models(name)
    jdense = jax.device_get(jax_init_dense(jmodel, 0))
    tdense = tmodel.init_dense(torch.Generator().manual_seed(0), "cpu")
    convert.dense_from_numpy(tdense, jdense)         # raises on a mismatch
    assert keys <= set(tdense.state_dict())
