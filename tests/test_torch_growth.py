"""Port parity for table growth, compaction and host export/import: tables
carried across from the JAX package (``to_port``) go through the same calls
in both packages and must leave bit-identical headers, payloads and deletion
logs (placement is a pure function of keys, their order and capacity; rows
move by exact copies). Exports must give equal arrays.

The JAX side compiles every eager op once per shape, so the tests feed it
few shapes: keys go in batches of ``CHUNK`` and tables share widths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfplus_tpu import kv as jkv
from tfplus_tpu import models as jmodels
from tfplus_tpu import train as jtrain
from tfplus_tpu_torch import convert, kv as tkv
from tfplus_tpu_torch import models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu_torch.kv import table as ttable
from test_torch_table import assert_same_table, jax_init_state, to_port


CHUNK = 64


def _ids(rng, n):
    return rng.permutation(np.unique(rng.randint(0, 1 << 40, n + 8,
                                                 dtype=np.int64)))[:n]


def _filled(rng, n, capacity=256, dtype=jnp.float32, slots=False, **kw):
    """A JAX table with ``n`` rows (a multiple of ``CHUNK``) placed by
    ``lookup_or_insert``, slot columns holding random values, and its port
    copy."""
    jt = jkv.create(8, capacity, value_dtype=dtype, init_pool_rows=40,
                    seed=2, **kw)
    if slots:
        jt = jkv.ensure_slots(jt, {"m": 1, "v": 2})
    ids = _ids(rng, n)
    for a in range(0, n, CHUNK):
        jt = jkv.lookup_or_insert(
            jt, jkv.encode_ids_np_to_device(ids[a:a + CHUNK]), day=9).table
    w = jt.payload.shape[1]
    if w > 8:        # slot columns with data, to see them move
        noise = rng.randn(capacity, w).astype(np.float32)
        occ = np.asarray(jkv.occupied_mask(jt))[:, None]
        jt = dataclasses.replace(jt, payload=jnp.where(
            occ, jnp.asarray(noise, dtype), jt.payload))
    return jt, to_port(jt), ids


@pytest.mark.parametrize("dtype,slots", [(jnp.float32, True),
                                         (jnp.float16, False),
                                         (jnp.bfloat16, True)],
                         ids=["f32-slots", "f16", "bf16-slots"])
def test_grow_and_chained_doublings_match_jax(dtype, slots):
    rng = np.random.RandomState(1)
    jt, tt, ids = _filled(rng, 128, dtype=dtype, slots=slots)
    jg, tg = jkv.grow(jt), tkv.grow(tt)
    assert tg.capacity == 512 and tg is not tt
    assert_same_table(jg, tg)
    # grow_to_fit: two chained doublings to fit 400 more rows
    jg, tg = jkv.grow_to_fit(jt, 400), tkv.grow_to_fit(tt, 400)
    assert tg.capacity == 1024
    assert_same_table(jg, tg)
    assert tkv.grow_to_fit(tg, 10) is tg              # already fits
    q = tkv.encode_ids_np_to_device(ids, "cpu")
    np.testing.assert_array_equal(
        tkv.lookup_or_zeros(tg, q).float().numpy(),
        tkv.lookup_or_zeros(tt, q).float().numpy())
    with pytest.raises(ValueError):
        tkv.grow(tt, 384)
    with pytest.raises(ValueError):
        tkv.grow(tt, 128)


def test_doubling_spill_on_the_adjustment_edge(monkeypatch):
    """Rows placed in an adjusted second bucket (b2 == b1 → b1 + 1) fall
    outside both computed doubling targets: they spill into one claim
    pass, in both packages alike."""
    rng = np.random.RandomState(26)
    ids = rng.randint(0, 1 << 40, 44).astype(np.int64)
    jt = jkv.create(4, 64, init_pool_rows=20, seed=0)
    jt = jkv.lookup_or_insert(jt, jkv.encode_ids_np_to_device(ids)).table
    tt = to_port(jt)
    claims = []
    claim = ttable._claim_insert
    monkeypatch.setattr(ttable, "_claim_insert",
                        lambda *a, **k: claims.append(1) or claim(*a, **k))
    tg = tkv.grow(tt)
    assert claims == [1], "the doubling should spill exactly once"
    assert_same_table(jkv.grow(jt), tg)
    assert int(tkv.size(tg)) == int(tkv.size(tt))


def test_compact_after_heavy_deletion_matches_jax():
    rng = np.random.RandomState(2)
    jt, tt, ids = _filled(rng, 128, slots=True)
    gone = ids[:96]
    jt, _ = jkv.delete(jt, jkv.encode_ids_np_to_device(gone))
    tt, _ = tkv.delete(tt, tkv.encode_ids_np_to_device(gone, "cpu"))
    jc, tc = jkv.compact(jt), tkv.compact(tt)
    assert tc.capacity == 256
    assert not bool(tkv.table.hashing.is_tombstone(tc.keys).any())
    assert_same_table(jc, tc)


def test_import_that_must_grow_matches_jax():
    """Past the load factor (grow first), and the bucket-pair collision
    of test_kv_table.py: 40 keys sharing one (b1, b2) pair overflow 32
    lanes under the load factor, so the import grows and re-inserts."""
    rng = np.random.RandomState(3)
    src, _, _ = _filled(rng, 128)
    data = jkv.export_arrays(src, as_of_unix_day=20100)
    jt = jkv.import_arrays(jkv.create(8, 64, seed=5), data)
    tt = tkv.import_arrays(to_port(jkv.create(8, 64, seed=5)), data)
    assert tt.capacity == 256
    assert_same_table(jt, tt)

    cap = 512
    cand = np.arange(1, 300_000, dtype=np.int64)
    b1, b2 = tkv.table.hashing.bucket_choices(
        tkv.encode_ids_np_to_device(cand, "cpu"), cap)
    pair = (b1 * (cap // 16) + b2).numpy()
    vals, counts = np.unique(pair, return_counts=True)
    collide = cand[pair == vals[np.argmax(counts)]][:40]
    assert len(collide) == 40, "collision search failed"
    data = {"keys": collide.astype(np.uint64),
            "values": np.arange(40 * 8, dtype=np.float32).reshape(40, 8)}
    jt = jkv.import_arrays(jkv.create(8, cap, seed=1), data, day=3)
    tt = tkv.import_arrays(to_port(jkv.create(8, cap, seed=1)), data, day=3)
    assert tt.capacity > cap and int(tkv.size(tt)) == 40
    assert_same_table(jt, tt)


def _assert_same_export(je, te):
    assert sorted(je) == sorted(te)
    for k in je:
        if k == "table":
            assert_same_table(je[k], te[k])
        else:
            a, b = np.asarray(je[k]), np.asarray(te[k])
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, k)


@pytest.mark.parametrize("pred_delta", [False, True])
def test_export_arrays_matches_jax(pred_delta):
    """Full, cutoff and delta exports of both streams, with deletions and
    blacklisted rows, with and without ``support_prediction_delta``."""
    rng = np.random.RandomState(4)
    jt, tt, ids = _filled(rng, 128, slots=True,
                          support_prediction_delta=pred_delta)
    # zero rows (cut off) and blacklisted rows (kept as keys)
    sel = ids[:16]
    zeros = jnp.zeros((16, 8))
    black = np.arange(16) % 3 == 0
    jt = jkv.insert(jt, jkv.encode_ids_np_to_device(sel), zeros, day=20,
                    blacklist=jnp.asarray(black))
    tt = tkv.insert(tt, tkv.encode_ids_np_to_device(sel, "cpu"),
                    torch.zeros(16, 8), day=20,
                    blacklist=torch.from_numpy(black))
    day = 20003
    for kw in (dict(), dict(enable_cutoff=True),
               dict(clear_deltalist=True, deltalist="pred")):
        je = jkv.export_arrays(jt, as_of_unix_day=day, **kw)
        te = tkv.export_arrays(tt, as_of_unix_day=day, **kw)
        _assert_same_export(je, te)
        if "table" in je:
            jt, tt = je["table"], te["table"]
    for step, stream in enumerate(("train", "pred", "train")):
        gone = ids[20 + 16 * step:36 + 16 * step]
        jt, _ = jkv.delete(jt, jkv.encode_ids_np_to_device(gone))
        tt, _ = tkv.delete(tt, tkv.encode_ids_np_to_device(gone, "cpu"))
        more = _ids(rng, 16)
        jt = jkv.lookup_or_insert(jt, jkv.encode_ids_np_to_device(more),
                                  day=21).table
        tt = tkv.lookup_or_insert(tt, tkv.encode_ids_np_to_device(more, "cpu"),
                                  day=21).table
        je = jkv.export_arrays(jt, delta=True, deltalist=stream,
                               as_of_unix_day=day)
        te = tkv.export_arrays(tt, delta=True, deltalist=stream,
                               as_of_unix_day=day)
        assert te["table"] is tt and len(te["delete_keys"]) > 0
        _assert_same_export(je, te)
        jt, tt = je["table"], te["table"]
        start, count = tkv.table.pending_delete_span(tt, "pred")
        jstart, jcount = jkv.table.pending_delete_span(jt, "pred")
        assert (int(start), int(count)) == (int(jstart), int(jcount))


def test_grow_if_needed_during_dcn_training_matches_jax():
    """Three DCN steps of 8 ids per table from tables of 32 rows,
    ``grow_if_needed`` before each: both packages grow the same tables
    before step 3, and the headers stay bit for bit."""
    kw = dict(embedding_dims=(8, 8, 16), num_numeric=5, dnn_hidden=(16, 8),
              capacity=32)
    jmodel, tmodel = jmodels.DCN(**kw), tmodels.DCN(**kw)
    jopt, topt = jtrain.AdagradOptimizer(), ttrain.AdagradOptimizer()
    tx = optax.adam(0.01)
    jstate = jax_init_state(jmodel, jopt, tx, seed=0)
    dense = tmodel.init_dense(torch.Generator().manual_seed(1), "cpu")
    convert.dense_from_numpy(dense, jax.device_get(jstate.dense))
    tstate = tmodels.TrainState(
        tables={n: to_port(t) for n, t in jstate.tables.items()},
        dense=dense, opt_state=torch.optim.Adam(dense.parameters(), lr=0.01),
        step=torch.zeros((), dtype=torch.int32))
    jstep = jmodels.make_train_step(jmodel, jopt, tx, sparse_lr=0.05)
    tstep = tmodels.make_train_step(tmodel, topt, sparse_lr=0.05)
    rng = np.random.RandomState(5)
    batch = 8
    caps = []
    for _ in range(3):
        b = {"ids": {f"C{i + 1}": rng.randint(1, 1 << 30, batch)
                     .astype(np.int32) for i in range(3)},
             "features": rng.randn(batch, 5).astype(np.float32),
             "labels": rng.randint(0, 2, batch).astype(np.float32)}
        jstate = jmodels.grow_if_needed(jstate, batch)
        tstate = tmodels.grow_if_needed(tstate, batch)
        jstate, jloss, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                                b))
        tstate, tloss, _ = tstep(tstate, b)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5)
        caps.append(tstate.tables["C1"].capacity)
        for n, jt in jstate.tables.items():
            np.testing.assert_array_equal(tstate.tables[n].header.numpy(),
                                          np.asarray(jt.header), n)
    assert caps == [32, 32, 64], caps
