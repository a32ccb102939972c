"""Port parity for multi-table packing and the module adapter.

``kv.multi``'s tagging and split export match the JAX package bit for bit;
``make_train_step_multi`` on a small DCN (GroupAdam) starts from one state
in both packages (``convert.state_from_numpy``) and trains three steps on
the same batches, then serves one: headers and slot-free meta bit for bit,
losses within 1e-5 and float state within 2e-5 / 1e-4, the tolerances of
``test_torch_train.py`` (which states why). ``ModuleSparseModel`` trains a
small tower against ``FlaxSparseModel`` with the weights carried across by
``convert``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import kv as jkv
from tfplus_tpu import models as jmodels
from tfplus_tpu import train as jtrain
from tfplus_tpu.kv import multi as jmulti
from tfplus_tpu_torch import convert
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu_torch.kv import multi as tmulti
from test_torch_table import jax_init_dense

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=2e-5, rtol=1e-4)
SPARSE_LR, DENSE_LR = 0.05, 0.01
BATCH = 16


@pytest.mark.parametrize("logical_id", [0, 5, 2047, 2048, 4095])
def test_tag_and_untag_match_jax(logical_id):
    """Host uint64 tagging, device tagging of raw and encoded ids (the high
    word wraps to a negative int32 from tag 2048 up) and the host untag."""
    rng = np.random.RandomState(logical_id)
    ids = rng.randint(0, 2**63, 64, dtype=np.int64).astype(np.uint64)
    ids[:8] |= np.uint64(1 << 63)
    np.testing.assert_array_equal(jmulti.tag_ids(ids, logical_id),
                                  tmulti.tag_ids(ids, logical_id))
    enc = jkv.encode_ids_np_to_device(ids)
    got = tmulti.tag_ids(tkv.encode_ids_np_to_device(ids, "cpu"), logical_id)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jmulti.tag_ids(enc, logical_id)), got.numpy())
    raw = rng.randint(-2**31, 2**31, 64).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jmulti.tag_ids(jnp.asarray(raw), logical_id)),
        tmulti.tag_ids(torch.from_numpy(raw), logical_id).numpy())
    keys = tkv.decode_ids_np(got)
    for a, b in zip(jmulti.untag_ids_np(keys), tmulti.untag_ids_np(keys)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        tmulti.tag_ids(ids, 4096)


def test_multi_table_export_split_matches_jax():
    rng = np.random.RandomState(3)
    pool = (rng.randn(100, 8) * 0.05).astype(np.float32)
    jm = jmulti.MultiTable(8, 256, initializer=jnp.asarray(pool))
    tm = tmulti.MultiTable(8, 256, initializer=pool, device="cpu")
    names = ["user", "item", "ad"]
    for n in names:
        assert jm.register(n) == tm.register(n)
    assert tm.register("item") == 1 and tm.logical_id("ad") == 2
    lookup = jax.jit(lambda t, q: jkv.lookup_or_insert(t, q, day=3).table)
    for n in names:
        ids = rng.randint(0, 1 << 50, 40, dtype=np.int64)
        jm.table = lookup(jm.table,
                          jkv.encode_ids_np_to_device(jm.tag(n, ids)))
        tkv.lookup_or_insert(
            tm.table, tkv.encode_ids_np_to_device(tm.tag(n, ids), "cpu"),
            day=3)
    np.testing.assert_array_equal(np.asarray(jm.table.header),
                                  tm.table.header.numpy())
    jex, tex = jm.export_split(), tm.export_split()
    assert list(jex) == list(tex) == names
    for n in names:
        for k in ("keys", "values", "freq_values"):
            np.testing.assert_array_equal(jex[n][k], tex[n][k], f"{n}.{k}")
            assert jex[n][k].dtype == tex[n][k].dtype


def _dcn_batch(rng, dims):
    return {"ids": {f"C{i + 1}": rng.randint(1, 40, BATCH).astype(np.int64)
                    for i in range(len(dims))},
            "features": rng.randn(BATCH, 5).astype(np.float32),
            "labels": rng.randint(0, 2, BATCH).astype(np.float32)}


def _jax_batch(b):
    return {"ids": {k: jkv.encode_ids_np_to_device(v)
                    for k, v in b["ids"].items()},
            "features": jnp.asarray(b["features"]),
            "labels": jnp.asarray(b["labels"])}


def test_multi_table_step_matches_jax():
    dims = (8, 16, 8, 16, 8)
    kw = dict(embedding_dims=dims, num_numeric=5, dnn_hidden=(16, 8))
    jmodel, tmodel = jmodels.DCN(**kw), tmodels.DCN(**kw)
    opt_kw = dict(l1_regularization_strength=0.001)
    jopt = jtrain.GroupAdamOptimizer(**opt_kw)
    topt = ttrain.GroupAdamOptimizer(**opt_kw)
    tx = optax.adam(DENSE_LR)
    dense = jax_init_dense(jmodel, 0)
    jstate = jmodels.init_state_multi(jmodel, jopt, tx,
                                      capacity_per_group=256)
    jstate = jstate._replace(dense=dense, opt_state=jax.jit(tx.init)(dense))
    tstate = convert.state_from_numpy(
        jax.device_get(jstate), tmodel,
        functools.partial(torch.optim.Adam, lr=DENSE_LR), device="cpu")
    assert sorted(tstate.tables) == ["__group_16", "__group_8"]
    # the port's own init gives the same empty tables (its init pools come
    # from torch's generator, not JAX's)
    own = tmodels.init_state_multi(tmodel, topt, capacity_per_group=256,
                                   device="cpu")
    assert list(own.tables) == list(jstate.tables)
    for name, jt in jstate.tables.items():
        np.testing.assert_array_equal(own.tables[name].header.numpy(),
                                      np.asarray(jt.header))
        assert own.tables[name].config == tstate.tables[name].config
    jstep = jmodels.make_train_step_multi(jmodel, jopt, tx,
                                          sparse_lr=SPARSE_LR)
    tstep = tmodels.make_train_step_multi(tmodel, topt, sparse_lr=SPARSE_LR)
    rng = np.random.RandomState(4)
    for _ in range(3):
        b = _dcn_batch(rng, dims)
        jstate, jloss, jpreds = jstep(jstate, _jax_batch(b))
        tstate, tloss, tpreds = tstep(tstate, b)
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
        np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds),
                                   **LOSS_TOL)
    assert int(tstate.step) == int(jstate.step) == 3
    for n, jt in jstate.tables.items():
        tt = tstate.tables[n]
        np.testing.assert_array_equal(tt.header.numpy(),
                                      np.asarray(jt.header), n)
        np.testing.assert_allclose(tt.payload.numpy(), np.asarray(jt.payload),
                                   err_msg=n, **STATE_TOL)
        assert int(tkv.size(tt)) > 0
    jserve = jmodels.make_train_step_multi(jmodel, jopt, tx,
                                           sparse_lr=SPARSE_LR, train=False)
    tserve = tmodels.make_train_step_multi(tmodel, train=False)
    b = _dcn_batch(rng, dims)
    b["ids"]["C2"][:4] = 1 << 45                      # unseen ids
    _, jloss, jpreds = jserve(jstate, _jax_batch(b))
    headers = {n: t.header.clone() for n, t in tstate.tables.items()}
    _, tloss, tpreds = tserve(tstate, b)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **LOSS_TOL)
    for n, t in tstate.tables.items():          # serving never inserts
        assert torch.equal(t.header, headers[n])


def test_multi_table_step_reruns_bit_for_bit():
    """Two runs from cloned states give the same bits."""
    kw = dict(embedding_dims=(8, 16, 8), num_numeric=5, dnn_hidden=(16, 8))
    model = tmodels.DCN(**kw)
    opt = ttrain.GroupAdamOptimizer()
    batches = [_dcn_batch(np.random.RandomState(s), kw["embedding_dims"])
               for s in range(3)]
    runs = []
    for _ in range(2):
        state = tmodels.init_state_multi(
            model, opt, functools.partial(torch.optim.Adam, lr=DENSE_LR),
            seed=1, capacity_per_group=256, device="cpu")
        step = tmodels.make_train_step_multi(model, opt, sparse_lr=SPARSE_LR)
        losses = [step(state, b)[1] for b in batches]
        runs.append((losses, {n: t.payload.clone()
                              for n, t in state.tables.items()}))
    assert [float(x) for x in runs[0][0]] == [float(x) for x in runs[1][0]]
    for n in runs[0][1]:
        assert torch.equal(runs[0][1][n], runs[1][1][n])


class _Dense(torch.nn.Module):
    def __init__(self, d_in, d_out, generator, device):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.randn(
            d_in, d_out, generator=generator).to(device) / d_in ** 0.5)
        self.bias = torch.nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _Tower(torch.nn.Module):
    """The PyTorch twin of the Flax tower below; parameter names follow
    Flax's (``params.Dense_<i>.kernel``)."""

    def __init__(self, generator, device):
        super().__init__()
        self.params = torch.nn.ModuleDict({
            f"Dense_{i}": _Dense(a, b, generator, device)
            for i, (a, b) in enumerate(((20, 32), (32, 16), (16, 1)))})

    def forward(self, embeddings, features):
        x = torch.cat([embeddings["C1"], embeddings["C2"], features], dim=-1)
        x = torch.relu(self.params["Dense_0"](x))
        x = torch.relu(self.params["Dense_1"](x))
        return self.params["Dense_2"](x)[..., 0]


def test_module_adapter_trains_like_the_flax_adapter():
    import flax.linen as fnn

    class Tower(fnn.Module):
        @fnn.compact
        def __call__(self, embeddings, features):
            x = jnp.concatenate(
                [embeddings["C1"], embeddings["C2"], features], axis=-1)
            x = fnn.relu(fnn.Dense(32)(x))
            x = fnn.relu(fnn.Dense(16)(x))
            return fnn.Dense(1)(x)[..., 0]

    specs = {"C1": dict(dim=8, capacity=256), "C2": dict(dim=8, capacity=256)}
    jmodel = jmodels.FlaxSparseModel(Tower(), specs, feature_dim=4)
    tmodel = tmodels.ModuleSparseModel(_Tower, specs, feature_dim=4)
    assert isinstance(tmodel.init_dense(torch.Generator(), "cpu"), _Tower)
    jopt, topt = jtrain.AdagradOptimizer(), ttrain.AdagradOptimizer()
    tx = optax.adam(DENSE_LR)
    dense = jax_init_dense(jmodel, 0)
    jstate = jmodels.TrainState(tables=jmodel.init_tables(jopt, 0),
                                dense=dense, opt_state=jax.jit(tx.init)(dense),
                                step=jnp.zeros((), jnp.int32))
    tstate = convert.state_from_numpy(
        jax.device_get(jstate), tmodel,
        functools.partial(torch.optim.Adam, lr=DENSE_LR), device="cpu")
    jstep = jmodels.make_train_step(jmodel, jopt, tx, sparse_lr=SPARSE_LR)
    tstep = tmodels.make_train_step(tmodel, topt, sparse_lr=SPARSE_LR)
    rng = np.random.RandomState(8)
    for _ in range(3):
        b = {"ids": {n: rng.randint(1, 30, BATCH).astype(np.int64)
                     for n in specs},
             "features": rng.randn(BATCH, 4).astype(np.float32),
             "labels": rng.randint(0, 2, BATCH).astype(np.float32)}
        jstate, jloss, _ = jstep(jstate, _jax_batch(b))
        tstate, tloss, _ = tstep(tstate, b)
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    for n, jt in jstate.tables.items():
        np.testing.assert_array_equal(tstate.tables[n].header.numpy(),
                                      np.asarray(jt.header), n)
        np.testing.assert_allclose(tstate.tables[n].payload.numpy(),
                                   np.asarray(jt.payload), **STATE_TOL)
    want = jax.device_get(jstate.dense)["params"]
    for name, p in tstate.dense.named_parameters():
        _, layer, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), want[layer][leaf],
                                   err_msg=name, **STATE_TOL)
