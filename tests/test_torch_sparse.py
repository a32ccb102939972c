"""Port parity for the sparse lookups: the combiners (sum, mean, sqrtn,
weighted or not), ``embedding_lookup_sparse``, ``safe_embedding_lookup_sparse``
(negative ids and weights <= 0 pruned, raw uint64 ids exempt, empty rows
given the default id's row or zeros) and ``grads_to_unique``, and autograd
through ``combine`` against ``jax.grad``.

Tolerances. The segment sums add the same float32 terms as JAX's
``segment_sum`` but in an order of their own (a sorted ``index_put_`` on the
card, a serial ``index_add_`` on the CPU), so outputs are held within
``atol = 1e-6 · max|row|`` and ``rtol = 1e-6`` (a few float32 ulps of sums
of up to 8 terms). Gradients go through a division and, for sqrtn, a square
root: ``atol = rtol = 1e-5``. Tables (the train-mode lookups insert) match
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import embedding as jemb
from tfplus_tpu import kv as jkv
from tfplus_tpu_torch import embedding as temb
from tfplus_tpu_torch import kv as tkv
from test_torch_table import assert_same, assert_same_table, to_port

DIM, ROWS, BATCH, N = 8, 100, 16, 64
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _tables():
    """``(ids, JAX table, port table)`` with ROWS rows inserted."""
    rng = np.random.RandomState(0)
    jt = jkv.create(DIM, 256, init_pool_rows=50, seed=1)
    tt = to_port(jt)
    ids = rng.permutation(np.unique(rng.randint(1, 1 << 40, ROWS + 20)))[:ROWS]
    rows = rng.randn(ROWS, DIM).astype(np.float32)
    jt = jkv.insert(jt, jkv.encode_ids_np_to_device(ids), jnp.asarray(rows),
                    day=5)
    tt = tkv.insert(tt, tkv.encode_ids_np_to_device(ids, "cpu"),
                    torch.from_numpy(rows), day=5)
    return ids, jt, tt


def _sparse_batch(rng, ids):
    """N entries over BATCH rows: known, unknown and negative ids, one row
    with no entry, weights with some <= 0."""
    q = rng.choice(ids, N).astype(np.int64)
    q[:6] = -q[:6]
    q[6:10] = rng.randint(1 << 41, 1 << 42, 4)
    seg = rng.randint(0, BATCH, N).astype(np.int32)
    seg[seg == 3] = 4                 # row 3 has no entry,
    seg[seg == 7] = 8
    seg[:3] = 7                       # row 7 only negative ids
    w = rng.rand(N).astype(np.float32) + 0.05
    w[10:13] = [-0.5, 0.0, -2.0]
    return q, seg, w


def assert_close(jx, tx):
    jx, tx = np.asarray(jx), tx.detach().numpy()
    scale = max(float(np.abs(jx).max()), 1e-30)
    np.testing.assert_allclose(tx, jx, atol=1e-6 * scale, rtol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True])
def test_safe_embedding_lookup_sparse_matches_jax(combiner, weighted):
    ids, jt, tt = _tables()
    rng = np.random.RandomState(1)
    for step, default_id in enumerate((int(ids[3]), None)):
        q, seg, w = _sparse_batch(rng, ids)
        jw = jnp.asarray(w) if weighted else None
        tw = torch.from_numpy(w) if weighted else None
        for train in (False, True):
            jo, jl, jt = jemb.safe_embedding_lookup_sparse(
                jt, q, seg, BATCH, weights=jw, combiner=combiner,
                default_id=default_id, train=train, day=6 + step)
            to, tl, tt = temb.safe_embedding_lookup_sparse(
                tt, q, seg, BATCH, weights=tw, combiner=combiner,
                default_id=default_id, train=train, day=6 + step)
            assert_close(jo, to)
            for f in ("slot", "inverse", "counts", "valid", "num_unique"):
                assert_same(getattr(jl, f), getattr(tl, f), f)
            assert_same_table(jt, tt)
        # rows 3 and 7 have no surviving entry
        want = (tkv.lookup_or_zeros(tt, tkv.encode_ids(
            np.array([default_id], np.int64), "cpu"))[0]
            if default_id is not None else torch.zeros(DIM))
        assert torch.equal(to[3], want) and torch.equal(to[7], want)


def test_lookup_sparse_padding_and_uint64_ids_match_jax():
    """A padding mask through ``embedding_lookup_sparse``; raw uint64 ids
    with the top bit set are kept by the safe lookup (no sign to prune),
    and pruned when the same ids come as int64."""
    ids, jt, tt = _tables()
    rng = np.random.RandomState(2)
    q, seg, w = _sparse_batch(rng, ids)
    valid = rng.rand(N) < 0.8
    jo, _, jt = jemb.embedding_lookup_sparse(
        jt, np.abs(q), seg, BATCH, weights=jnp.asarray(w),
        valid=jnp.asarray(valid), combiner="mean", day=7)
    to, _, tt = temb.embedding_lookup_sparse(
        tt, np.abs(q), seg, BATCH, weights=torch.from_numpy(w),
        valid=torch.from_numpy(valid), combiner="mean", day=7)
    assert_close(jo, to)
    assert_same_table(jt, tt)
    big = np.abs(q).astype(np.uint64) | np.uint64(1 << 63)
    for raw in (big, big.view(np.int64)):
        jo, jl, _ = jemb.safe_embedding_lookup_sparse(
            jt, raw, seg, BATCH, combiner="sum", train=False)
        to, tl, _ = temb.safe_embedding_lookup_sparse(
            tt, raw, seg, BATCH, combiner="sum", train=False)
        assert_close(jo, to)
        assert_same(jl.valid, tl.valid)
        assert bool(tl.valid.all()) == (raw.dtype == np.uint64)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combine_gradients_match_jax_grad(combiner):
    """Autograd through ``combine`` with respect to the unique rows and the
    weights, against ``jax.grad`` of the same function."""
    ids, jt, tt = _tables()
    rng = np.random.RandomState(3)
    q = rng.choice(ids, N)
    seg = np.sort(rng.randint(0, BATCH, N)).astype(np.int32)
    w = (rng.rand(N) + 0.1).astype(np.float32)
    valid = rng.rand(N) < 0.9
    jl, _ = jemb.lookup_unique(jt, q, train=False, valid=jnp.asarray(valid))
    tl, _ = temb.lookup_unique(tt, q, train=False,
                               valid=torch.from_numpy(valid))

    def jf(rows, weights):
        out = jemb.combine(jl, jnp.asarray(seg), BATCH, rows=rows,
                           weights=weights, combiner=combiner)
        return jnp.sum(jnp.sin(out) * jnp.arange(DIM))

    jgr, jgw = jax.grad(jf, argnums=(0, 1))(jl.rows, jnp.asarray(w))
    rows = tl.rows.clone().requires_grad_()
    weights = torch.from_numpy(w).requires_grad_()
    out = temb.combine(tl, torch.from_numpy(seg), BATCH, rows=rows,
                       weights=weights, combiner=combiner)
    torch.sum(torch.sin(out) * torch.arange(DIM)).backward()
    np.testing.assert_allclose(rows.grad.numpy(), np.asarray(jgr), **GRAD_TOL)
    np.testing.assert_allclose(weights.grad.numpy(), np.asarray(jgw),
                               **GRAD_TOL)
    g = rng.randn(N, DIM).astype(np.float32)
    assert_close(jemb.grads_to_unique(jl, jnp.asarray(g)),
                 temb.grads_to_unique(tl, torch.from_numpy(g)))


def test_combine_rows_rejects_an_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        temb.combine_rows(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32),
                          2, combiner="max")
