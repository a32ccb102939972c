"""Port parity for the optimizer suite: every rule, ``SparseOptimizer.apply``
on tables and the dense twin, against the JAX package on the same numpy
inputs.

Tolerances. The rules are float32 elementwise math on both sides; XLA's and
PyTorch's exp/sqrt/log may differ in the last bit and the group norms sum
in another order, and three steps carry that through (the group-lasso
scale ``1 - l21/‖·‖`` and Adam's ``m/√v`` amplify it where they nearly
cancel), so ``rtol = 1e-5`` with ``atol = 1e-6``. Blacklist masks, table
headers and meta words are compared bit for bit. bf16 payloads round once
at the store after the same f32 math, so they may differ by one bf16 ulp
(``rtol = 2^-7``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import embedding as jemb, kv as jkv, train as jtrain
from tfplus_tpu.optim import dense as jdense, rules as jr
from tfplus_tpu_torch import embedding as temb, kv as tkv, train as ttrain
from tfplus_tpu_torch.optim import dense as tdense, rules as tr
from test_torch_table import assert_same_table, to_port

TOL = dict(rtol=1e-5, atol=1e-6)
N, D = 6, 8
REG = dict(l1=0.01, l2=0.02, l21=0.05)

# (name, kwargs, lr); every rule of the JAX file, the group rules with and
# without regularisation
RULES = [
    ("Sgd", {}, 0.1), ("Adagrad", {}, 0.1), ("Adam", {}, 0.01),
    ("GroupAdam", {}, 0.01), ("GroupAdam", dict(REG, l21=2.0), 0.01),
    ("GroupAdamV1", {}, 0.01), ("GroupAdamV1", REG, 0.01),
    ("GroupFtrl", {}, 0.1), ("GroupFtrl", REG, 0.1),
    ("GroupFtrl", dict(lr_power=-0.3, l2_shrinkage=0.01), 0.1),
    ("GroupFtrl", dict(lr_power=0.0, initial_accumulator_value=0.0), 0.1),
    ("GroupMomentum", {}, 0.05),
    ("GroupMomentum", dict(REG, use_nesterov=True), 0.05),
    ("GroupAdadelta", {}, 1.0), ("GroupAdadelta", REG, 1.0),
    ("GroupAMSGrad", {}, 0.01), ("GroupAMSGrad", REG, 0.01),
    ("GroupAdaBelief", {}, 0.01), ("GroupAdaBelief", REG, 0.01),
    ("GroupAdaHessian", {}, 0.01), ("GroupAdaHessian", REG, 0.01),
    ("GroupLamb", {}, 0.01), ("GroupLamb", REG, 0.01),
    ("GroupLambHessian", {}, 0.01), ("GroupLambHessian", REG, 0.01),
    ("LambHessian", {}, 0.01), ("AdaDQH", {}, 0.01),
    ("GroupAdaDQH", {}, 0.01), ("GroupAdaDQH", dict(REG, l21=1.0), 0.01),
    ("GroupAdaDQHV1", {}, 0.01), ("GroupAdaDQHV1", REG, 0.01),
    ("RAdam", {}, 0.01),
    ("RAdam", dict(amsgrad=True, weight_decay=0.01, total_steps=5), 0.01),
]


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **tol)


@pytest.mark.parametrize("name,kw,lr", RULES,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(RULES)])
def test_rule_matches_jax(name, kw, lr):
    jrule, trule = getattr(jr, name)(**kw), getattr(tr, name)(**kw)
    assert trule.slot_width == jrule.slot_width
    rng = np.random.RandomState(len(name) + len(kw))
    var = rng.randn(N, D).astype(np.float32) * 0.5
    var[0] = 0.0                                  # a blacklisted-looking row
    state = np.zeros((N, D * jrule.slot_width), np.float32)
    jvar, jstate, tvar, tstate = var, state, torch.from_numpy(var), \
        torch.from_numpy(state)
    for step in (1, 2, 3):
        g = (rng.randn(N, D) * 10.0 ** rng.uniform(-3, 0, (N, 1))).astype(
            np.float32)
        g[1] = 0.0                                # an untouched row
        extra = (rng.randn(N, D).astype(np.float32)
                 if jrule.needs_extra else None)
        jvar, jstate, jblack = jrule.update(
            jnp.asarray(jvar), jnp.asarray(jstate), jnp.asarray(g), lr=lr,
            step=jnp.int32(step),
            extra=None if extra is None else jnp.asarray(extra))
        tvar, tstate, tblack = trule.update(
            tvar, tstate, torch.from_numpy(g), lr=lr,
            step=torch.tensor(step, dtype=torch.int32),
            extra=None if extra is None else torch.from_numpy(extra))
        _close(tvar, jvar, what=f"var, step {step}")
        _close(tstate, jstate, what=f"state, step {step}")
        assert (tblack is None) == (jblack is None)
        if jblack is not None:
            np.testing.assert_array_equal(tblack.numpy(), np.asarray(jblack))


def test_norm_axis_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tr.GroupAdam(norm_axis="col")


@pytest.mark.parametrize("fn", ["adadqh_hg", "group_adadqh_hp"])
def test_hypergradient_computes_match_jax(fn):
    rng = np.random.RandomState(7)
    a = rng.randn(N, D).astype(np.float32)
    v = (rng.rand(N, D) * 1e-9 * rng.randint(0, 2, (N, D))).astype(
        np.float32) + rng.rand(N, D).astype(np.float32) * 1e-3
    kw = dict(lr=0.01, step=3)
    if fn == "adadqh_hg":
        kw.update(sam=True, delta=rng.randn(N, D).astype(np.float32),
                  alpha=0.5)
    else:
        kw.update(l1=0.1, l2=0.01, l21=0.3)
    jk = {k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    tk = {k: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
          for k, x in kw.items()}
    want = getattr(jr, fn)(jnp.asarray(a), jnp.asarray(v), **jk)
    got = getattr(tr, fn)(torch.from_numpy(a), torch.from_numpy(v), **tk)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# SparseOptimizer.apply on tables
# ---------------------------------------------------------------------------

def _tables(value_dtype, enter_threshold):
    jt = jkv.create(D, 256, seed=3, enter_threshold=enter_threshold,
                    value_dtype=value_dtype, init_pool_rows=64)
    return jt, to_port(jt)


@pytest.mark.parametrize("value_dtype,enter_threshold,reuse_rows", [
    (jnp.float32, 0, True), (jnp.float32, 2, True), (jnp.float32, 0, False),
    (jnp.bfloat16, 0, True)], ids=["f32", "freq-filter", "gather", "bf16"])
def test_sparse_apply_matches_jax(value_dtype, enter_threshold, reuse_rows):
    """GroupAdam with an l21 that blacklists the rows with small gradients;
    lookups in train mode with the meta write deferred to the optimizer
    (or, with a frequency filter, written by the lookup)."""
    jopt = jtrain.GroupAdamOptimizer(l21_regularization_strength=0.05)
    topt = ttrain.GroupAdamOptimizer(l21_regularization_strength=0.05)
    jt, tt = _tables(value_dtype, enter_threshold)
    jt, tt = jopt.init(jt), topt.init(tt)
    assert tt.config.slot_layout == (("m_v_linear", 3),)
    rng = np.random.RandomState(5)
    ids_all = rng.randint(0, 10_000, 30)
    black_rows = 0
    for step in (1, 2, 3):
        ids = rng.choice(ids_all, 40).astype(np.int32)
        jl, jt = jemb.lookup_unique(jt, ids, day=11, defer_meta=True)
        tl, tt = temb.lookup_unique(tt, ids, day=11, defer_meta=True)
        g = (rng.randn(40, D) * np.where(rng.rand(40, 1) < 0.3, 1e-4, 1.0)
             ).astype(np.float32)
        jkw = dict(lr=0.05, step=jnp.int32(step))
        tkw = dict(lr=0.05, step=torch.tensor(step, dtype=torch.int32))
        if reuse_rows:
            jkw.update(payload_rows=jl.payload_rows, meta_rows=jl.meta_rows)
            tkw.update(payload_rows=tl.payload_rows, meta_rows=tl.meta_rows)
        jt = jopt.apply(jt, jl.slot, jnp.asarray(g), **jkw)
        out = topt.apply(tt, tl.slot, torch.from_numpy(g), **tkw)
        assert out is tt
        np.testing.assert_array_equal(tt.header.numpy(),
                                      np.asarray(jt.header))
        black_rows = int(tkv.stats(tt)["blacklisted"])
        jp = np.asarray(jt.payload.astype(jnp.float32))
        tp = tt.payload.float().numpy()
        tol = TOL if value_dtype == jnp.float32 else dict(rtol=2.0 ** -7,
                                                          atol=1e-6)
        _close(tp, jp, tol, f"payload, step {step}")
    assert black_rows > 0                   # the l21 term did blacklist
    assert tkv.stats(tt) == jkv.table.stats(jt)


def test_apply_without_init_raises():
    _, tt = _tables(jnp.float32, 0)
    with pytest.raises(ValueError, match="init"):
        ttrain.AdamOptimizer().apply(
            tt, torch.zeros(1, dtype=torch.int32), torch.zeros(1, D),
            lr=0.1, step=1)


def test_sgd_table_matches_jax_bit_for_bit():
    """No slots: the payload keeps its width and the meta write marks."""
    jt, tt = _tables(jnp.float32, 0)
    ids = np.arange(1, 20, dtype=np.int32)
    jl, jt = jemb.lookup_unique(jt, ids, day=2)
    tl, tt = temb.lookup_unique(tt, ids, day=2)
    g = np.random.RandomState(1).randn(19, D).astype(np.float32)
    jt = jtrain.GradientDescentOptimizer().apply(jt, jl.slot, jnp.asarray(g),
                                                 lr=0.5, step=1)
    ttrain.GradientDescentOptimizer().apply(tt, tl.slot, torch.from_numpy(g),
                                            lr=0.5, step=1)
    assert_same_table(jt, tt)


# ---------------------------------------------------------------------------
# the dense twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,kw", [("Adam", {}), ("AdaDQH", {}),
                                     ("GroupAdam", dict(l1=0.01))])
def test_dense_twin_matches_as_optax(rule, kw):
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "s": np.float32(0.7)}
    tx = jdense.as_optax(getattr(jr, rule)(**kw), learning_rate=0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    topt = tdense.as_optimizer(getattr(tr, rule)(**kw), 0.05)(tp.values())
    for _ in range(3):
        g = {k: np.asarray(rng.randn(*np.shape(v)), np.float32)
             for k, v in params.items()}
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        for k in params:
            _close(tp[k].detach().numpy(), jp[k], what=k)
