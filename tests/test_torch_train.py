"""Port parity for sparse training: a small DCN (GroupAdam), BST (Adam) and
DIN (Adagrad) start from one state in both packages (tables carried across
with ``to_port``, dense weights with ``convert.dense_from_numpy``, a fresh
dense Adam on each side) and train three steps on the same batches.

Tolerances. Losses agree within 1e-5: float32 with another summation order
in the matmuls and (BST) the port's flash kernels' plain versions against
JAX's exact attention. Table headers (keys and meta words: frequency, day,
touch and blacklist bits) must match bit for bit. Payloads and dense
parameters move by Adam-type steps of up to about the learning rate
(0.05 sparse) whose relative error follows the gradients': about 1e-6 from
the summation order, but up to ~1e-3 on an element whose gradient nearly
cancels, so such an element may differ by ~1e-3 of a step, about 1e-5
after three steps: ``atol = 2e-5`` on values of order 0.05-1, with
``rtol = 1e-4`` for the small slot columns."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import models as jmodels
from tfplus_tpu import train as jtrain
from tfplus_tpu_torch import convert, models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu import kv as jkv
from tfplus_tpu_torch.kv import size as tkv_size
from test_torch_table import to_port


def _to_jax(tt):
    """A JAX table holding the port table's arrays (f32 payloads)."""
    import dataclasses
    jt = jkv.create(tt.dim, tt.capacity, init_pool_rows=1)
    jt = jkv.ensure_slots(jt, dict(tt.config.slot_layout))
    return dataclasses.replace(jt, **{
        f: jnp.asarray(getattr(tt, f).numpy())
        for f in ("header", "payload", "init_pool", "deleted_keys",
                  "deleted_count", "deleted_overflow", "deleted_seen_train",
                  "deleted_seen_pred")})

BATCH = 16
HIST = 6
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=2e-5, rtol=1e-4)
SPARSE_LR, DENSE_LR = 0.05, 0.01


def _setup(name):
    """(JAX model, port model, optimizer name, optimizer kwargs)."""
    if name == "DCN":
        kw = dict(embedding_dims=(8, 8, 16), num_numeric=5,
                  dnn_hidden=(16, 8), capacity=256)
        return (jmodels.DCN(**kw), tmodels.DCN(**kw), "GroupAdamOptimizer",
                dict(l1_regularization_strength=0.001))
    if name == "BST":
        kw = dict(embedding_dim=16, seq_len=HIST, num_numeric=3,
                  num_heads=2, head_dim=8, num_blocks=2, ffn_hidden=32,
                  dnn_hidden=(16, 8), capacity=256)
        return jmodels.BST(**kw), tmodels.BST(**kw), "AdamOptimizer", {}
    kw = dict(embedding_dim=8, seq_len=HIST, num_numeric=3,
              att_hidden=(12, 6), dnn_hidden=(16, 8), capacity=256)
    return jmodels.DIN(**kw), tmodels.DIN(**kw), "AdagradOptimizer", {}


def _batch(name, model, rng):
    universe = np.arange(1, 60)
    labels = rng.randint(0, 2, BATCH).astype(np.float32)
    if name == "DCN":
        return {"ids": {f"C{i + 1}": rng.choice(universe, BATCH)
                        .astype(np.int32) for i in range(3)},
                "features": rng.randn(BATCH, 5).astype(np.float32),
                "labels": labels}
    lengths = rng.randint(0, HIST + 1, BATCH)
    lengths[0] = 0
    mask = (np.arange(HIST)[None, :] < lengths[:, None]).astype(np.float32)
    seq = np.where(mask > 0, rng.choice(universe, (BATCH, HIST)), 0)
    return {"ids": {"item": model.pack_item_ids(rng.choice(universe, BATCH),
                                                seq).astype(np.int32),
                    "user": rng.choice(universe, BATCH).astype(np.int32)},
            "features": {"numeric": rng.randn(BATCH, 3).astype(np.float32),
                         "mask": mask},
            "labels": labels}


def _port_state(jstate, tmodel):
    dense = tmodel.init_dense(torch.Generator().manual_seed(1), "cpu")
    convert.dense_from_numpy(dense, jax.device_get(jstate.dense))
    return tmodels.TrainState(
        tables={n: to_port(t) for n, t in jstate.tables.items()},
        dense=dense, opt_state=torch.optim.Adam(dense.parameters(),
                                                lr=DENSE_LR),
        step=torch.zeros((), dtype=torch.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("name", ["DCN", "BST", "DIN"])
def test_training_matches_jax(name):
    jmodel, tmodel, opt_name, opt_kw = _setup(name)
    jopt = getattr(jtrain, opt_name)(**opt_kw)
    topt = getattr(ttrain, opt_name)(**opt_kw)
    tx = optax.adam(DENSE_LR)
    jstate = jmodels.init_state(jmodel, jopt, tx, seed=0)
    tstate = _port_state(jstate, tmodel)
    jstep = jmodels.make_train_step(jmodel, jopt, tx, sparse_lr=SPARSE_LR)
    tstep = tmodels.make_train_step(tmodel, topt, sparse_lr=SPARSE_LR)
    rng = np.random.RandomState(len(name))
    for _ in range(3):
        b = _batch(name, jmodel, rng)
        jstate, jloss, jpreds = jstep(jstate,
                                      jax.tree_util.tree_map(jnp.asarray, b))
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
    want = _flat(jax.device_get(jstate.dense))
    got = {k: v.detach().numpy() for k, v in tstate.dense.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATE_TOL)


def _fresh(model, opt):
    return tmodels.init_state(model, opt,
                              functools.partial(torch.optim.Adam, lr=1e-2),
                              seed=4, device="cpu")


def test_scan_equals_single_steps():
    """``make_train_step_scan`` over K stacked batches is K single steps:
    the same losses and bit-identical tables and weights."""
    _, model, _, _ = _setup("DIN")
    opt = ttrain.GroupAdamOptimizer()
    rng = np.random.RandomState(3)
    batches = [_batch("DIN", model, rng) for _ in range(3)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *batches)
    a, b = _fresh(model, opt), _fresh(model, opt)
    step = tmodels.make_train_step(model, opt, sparse_lr=0.05)
    losses = []
    for batch in batches:
        a, loss, _ = step(a, batch)
        losses.append(float(loss))
    b, scan_losses = tmodels.make_train_step_scan(model, opt,
                                                  sparse_lr=0.05)(b, stacked)
    assert scan_losses.shape == (3,) and int(b.step) == 3
    assert scan_losses.tolist() == losses
    for n in a.tables:
        assert torch.equal(a.tables[n].header, b.tables[n].header)
        assert torch.equal(a.tables[n].payload, b.tables[n].payload)
    for p, q in zip(a.dense.parameters(), b.dense.parameters()):
        assert torch.equal(p, q)
    assert tmodels.grow_if_needed(b, 10) is b
    # growth is ported: a table past the load factor is replaced by a grown
    # copy holding the same rows, bit for bit as the JAX package grows it
    grown = tmodels.grow_if_needed(b, 1_000)
    assert grown is not b and int(grown.step) == 3
    for n, t in b.tables.items():
        g = grown.tables[n]
        assert g.capacity >= 2048 and int(tkv_size(g)) == int(tkv_size(t))
        jt = jkv.grow_to_fit(_to_jax(t), 1_000)
        np.testing.assert_array_equal(g.header.numpy(), np.asarray(jt.header))
        np.testing.assert_array_equal(g.payload.numpy(),
                                      np.asarray(jt.payload))


def test_train_step_needs_its_optimizers():
    _, model, _, _ = _setup("DCN")
    with pytest.raises(ValueError, match="sparse_opt"):
        tmodels.make_train_step(model, train=True)


def test_take_backward_is_reproducible():
    """The inverse-index take's backward sums the gradients of duplicate
    ids in a fixed order: reruns are bit-identical at a size where
    autograd's own backward of indexing adds from several threads on the
    CPU, and the sums agree with it within float32 summation order."""
    from tfplus_tpu_torch import embedding as temb
    gen = torch.Generator().manual_seed(0)
    n, u, d = 50_000, 300, 64
    inverse = torch.randint(0, u, (n,), generator=gen, dtype=torch.int32)
    look = temb.Lookup(rows=None, slot=None, inverse=inverse, counts=None,
                       valid=torch.rand(n, generator=gen) < 0.9,
                       num_unique=None)
    rows = torch.randn(u, d, generator=gen)
    grad = torch.randn(n, d, generator=gen)

    def rows_grad(take):
        leaf = rows.clone().requires_grad_()
        (take(leaf) * grad).sum().backward()
        return leaf.grad

    got = rows_grad(lambda r: temb.gather(look, r))
    assert all(torch.equal(got, rows_grad(lambda r: temb.gather(look, r)))
               for _ in range(3))
    want = rows_grad(lambda r: torch.where(look.valid[:, None],
                                           r[inverse.long()], 0.0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)
