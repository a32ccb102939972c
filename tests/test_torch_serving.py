"""Port parity for serving: int8 tables, ranking metadata, the inference
export, the template-free load and the refresh from a trainer's delta.

Integer state must match the JAX package bit for bit, and here the floats
do too: quantization is one f32 division, a round half to even and a clamp
per element, the lookup one f32 product per element, and the f32 rebuild of
an int8 table before a refresh one product per element, each correctly
rounded in both packages. So headers (pad lanes with the scales included),
int8 payloads, scales, dequantized lookups and refreshed tables are compared
bit for bit. Exports and deltas written by either package load and refresh
in both, to the same tables."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import checkpoint as jckpt
from tfplus_tpu import kv as jkv
from tfplus_tpu import serving as jserving
from tfplus_tpu.kv import quant as jquant
from tfplus_tpu_torch import checkpoint as tckpt
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import serving as tserving
from tfplus_tpu_torch.kv import quant as tquant
from test_torch_table import (TORCH_DTYPE, assert_same, assert_same_table,
                              to_port)

DIM = 8
# the int8 error bound max|row|/254 holds in exact arithmetic; 2^-12 of it
# covers the float32 roundings of the division and the products
QUANT_SLACK = 2.0 ** -12


def _jenc(ids):
    return jkv.encode_ids_np_to_device(np.asarray(ids, np.int64))


def _tenc(ids):
    return tkv.encode_ids_np_to_device(np.asarray(ids, np.int64), "cpu")


def assert_same_quant(jq, tq):
    assert isinstance(tq, tquant.QuantKvTable)
    assert_same(jq.header, tq.header, "header")
    np.testing.assert_array_equal(np.asarray(jq.payload), tq.payload.numpy())
    assert_same(jq.scale, tq.scale, "scale")
    assert jq.config.slot_layout == tq.config.slot_layout == ()
    assert jq.nbytes == tq.nbytes


def _trained_pair(rng, n, dtype=jnp.float32, capacity=256):
    """A JAX table with slot columns, ``n`` rows (rows 0 and 1 all zero; a
    quarter of those after the tenth blacklisted) and its port copy;
    returns ``(ids, jt, tt)``."""
    jt = jkv.create(DIM, capacity, value_dtype=dtype, init_pool_rows=50,
                    seed=3)
    jt = jkv.ensure_slots(jt, {"m": 1})
    ids = rng.permutation(np.unique(rng.randint(1, 1 << 40, n + 20)))[:n]
    rows = (rng.randn(n, DIM) * rng.choice([0.01, 1.0, 30.0], (n, 1))
            ).astype(np.float32)
    rows[:2] = 0.0
    black = rng.rand(n) < 0.25
    black[:10] = False
    jt = jkv.insert(jt, _jenc(ids), jnp.asarray(rows, dtype), day=9,
                    blacklist=jnp.asarray(black))
    return ids, jt, to_port(jt)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_and_int8_lookup_match_jax(dtype):
    rng = np.random.RandomState(0)
    ids, jt, tt = _trained_pair(rng, 90, dtype)
    assert tt.payload.dtype == TORCH_DTYPE[np.dtype(dtype)]
    jq, tq = jquant.quantize_table(jt), tquant.quantize_table(tt)
    assert_same_quant(jq, tq)
    # the source table keeps its zero pad lanes and its slots
    assert_same_table(jt, tt)
    # known (some blacklisted, two all zero), unknown and reserved ids,
    # with and without a validity mask
    q = np.concatenate([ids, rng.randint(1 << 41, 1 << 42, 10)])
    jk = jnp.concatenate([_jenc(q), jnp.asarray([[-1, -1], [-2, -1]],
                                                jnp.int32)])
    tk = torch.cat([_tenc(q), torch.tensor([[-1, -1], [-2, -1]],
                                           dtype=torch.int32)])
    valid = rng.rand(jk.shape[0]) < 0.9
    assert_same(jquant.lookup_or_zeros(jq, jk), tquant.lookup_or_zeros(tq, tk))
    assert_same(jquant.lookup_or_zeros(jq, jk, jnp.asarray(valid)),
                tquant.lookup_or_zeros(tq, tk, torch.from_numpy(valid)))
    assert jquant.max_quant_error(jt) == tquant.max_quant_error(tt)
    # the bound by construction: |deq - v| <= max|row| / 254
    full = tkv.lookup_or_zeros(tt, _tenc(ids)).float()
    deq = tquant.lookup_or_zeros(tq, _tenc(ids))
    bound = full.abs().amax(dim=1, keepdim=True) / 254.0
    assert bool(((deq - full).abs() <= bound * (1 + QUANT_SLACK)).all())


def test_find_want_pad_and_table_views_match_jax():
    rng = np.random.RandomState(1)
    ids, jt, tt = _trained_pair(rng, 40)
    jq, tq = jquant.quantize_table(jt), tquant.quantize_table(tt)
    q = np.concatenate([ids[:30], rng.randint(1 << 41, 1 << 42, 10)])
    jf = jkv.find(jkv.KvTable(header=jq.header, payload=jt.payload,
                              init_pool=jt.init_pool,
                              deleted_keys=jt.deleted_keys,
                              deleted_count=jt.deleted_count,
                              deleted_overflow=jt.deleted_overflow,
                              deleted_seen_train=jt.deleted_seen_train,
                              deleted_seen_pred=jt.deleted_seen_pred,
                              config=jt.config), _jenc(q), want_pad=True)
    tf = tkv.find(tq, _tenc(q), want_pad=True)
    for f in ("slot", "found", "insert_slot", "meta", "pad"):
        assert_same(getattr(jf, f), getattr(tf, f), f)
    assert tkv.find(tt, _tenc(q)).pad is None
    assert_same(jt.values, tt.values)
    assert sorted(jt.slots) == sorted(tt.slots) == ["m"]
    assert_same(jt.slots["m"], tt.slots["m"])


def test_ranking_metadata_is_text_identical(tmp_path):
    cols = [dict(column_name="C1", var_name="embedding_weight_1",
                 embedding_dim=64, combiner="mean", num_shards=2),
            dict(column_name="user", var_name="user_emb", embedding_dim=8,
                 combiner="sqrtn", partition_strategy="div", bucket_size=7)]
    jmd, tmd = jserving.RankingMetadata(), tserving.RankingMetadata()
    for c in cols:
        jmd.add_embedding_column(**c)
        tmd.add_embedding_column(**c)
    assert tmd.to_json() == jmd.to_json()
    assert json.dumps(tmd.generate_signature(), indent=1) == json.dumps(
        jmd.generate_signature(), indent=1)
    jmd.save(str(tmp_path / "j.json"))
    tmd.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    assert tserving.RankingMetadata.load(str(tmp_path / "j.json")).to_json() \
        == jmd.to_json()


def _metadata(pkg, sharded):
    md = pkg.RankingMetadata()
    md.add_embedding_column(column_name="u", var_name="user_emb",
                            embedding_dim=DIM)
    if sharded:
        md.add_embedding_column(column_name="i", var_name="item_emb",
                                embedding_dim=DIM, num_shards=2)
    return md


def _load_both(directory, quantize):
    jt, jmd = jserving.load_for_serving(directory, quantize=quantize)
    tt, tmd = tserving.load_for_serving(directory, quantize=quantize,
                                        device="cpu")
    assert tmd.to_json() == jmd.to_json()
    return jt, tt


def _assert_same_tables(jtabs, ttabs, quantize):
    assert sorted(jtabs) == sorted(ttabs)
    for name in jtabs:
        js, ts = jtabs[name], ttabs[name]
        assert isinstance(js, list) == isinstance(ts, list)
        for a, b in zip(js if isinstance(js, list) else [js],
                        ts if isinstance(ts, list) else [ts]):
            if quantize:
                assert_same_quant(a, b)
            else:
                assert_same_table(a, b)
                assert not b.slots


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("quantize", [False, True])
def test_export_load_and_refresh_across_packages(tmp_path, writer, quantize):
    """One package exports a user table and a 2-shard item table (slot
    columns, blacklisted rows, a row under the cutoff) and later writes a
    trainer's delta (updated rows, new rows that make the loaded user table
    grow, deleted rows); both packages load the export with no templates
    and refresh from the delta, to the same tables. The restored init pool
    is the bundle's."""
    rng = np.random.RandomState(7 + quantize)
    ids, jt, tt = _trained_pair(rng, 40)
    item_ids = rng.randint(1, 1 << 40, 30)
    jitems = [jkv.insert(jkv.create(DIM, 128, init_pool_rows=20, seed=s),
                         _jenc(item_ids[s::2]),
                         jnp.asarray(rng.randn(15, DIM).astype(np.float32)),
                         day=4) for s in range(2)]
    titems = [to_port(t) for t in jitems]
    jt = jkv.insert(jt, _jenc(ids[5:6]), jnp.full((1, DIM), 1e-30))
    tt = tkv.insert(tt, _tenc(ids[5:6]), torch.full((1, DIM), 1e-30))
    d = str(tmp_path / "srv")
    if writer == "jax":
        prefix = jserving.export_for_serving(
            d, {"user_emb": jt, "item_emb": jitems}, _metadata(jserving, True))
    else:
        prefix = tserving.export_for_serving(
            d, {"user_emb": tt, "item_emb": titems},
            _metadata(tserving, True))
    assert prefix == d + "/serving"
    jtabs, ttabs = _load_both(d, quantize)
    _assert_same_tables(jtabs, ttabs, quantize)
    user = ttabs["user_emb"]
    # the all-zero rows and the 1e-30 row fall under the cutoff
    assert not bool(tkv.find(user, _tenc(ids[[0, 1, 5]])).found.any())
    loaded_capacity = user.capacity
    if not quantize:
        np.testing.assert_array_equal(user.init_pool.numpy(),
                                      tt.init_pool.numpy())

    # the trainer: a baseline, then updates, 70 new rows and 3 deletes
    jt, tt = jkv.clear_deltalist(jt), tkv.clear_deltalist(tt)
    upd = np.concatenate([ids[10:20], rng.randint(1 << 41, 1 << 42, 70)])
    rows = rng.randn(len(upd), DIM).astype(np.float32)
    jt = jkv.insert(jt, _jenc(upd), jnp.asarray(rows), day=11)
    tt = tkv.insert(tt, _tenc(upd), torch.from_numpy(rows), day=11)
    jt, _ = jkv.delete(jt, _jenc(ids[30:33]))
    tt, _ = tkv.delete(tt, _tenc(ids[30:33]))
    delta = str(tmp_path / "delta-1")
    if writer == "jax":
        jckpt.save(delta, {"user_emb": jt}, delta=True,
                   first_n=jckpt.FIRST_N_DELTA)
    else:
        tckpt.save(delta, {"user_emb": tt}, delta=True,
                   first_n=tckpt.FIRST_N_DELTA)
    jtabs = jserving.refresh_from_delta(jtabs, delta, quantize=quantize)
    before = ttabs["user_emb"]
    ttabs = tserving.refresh_from_delta(ttabs, delta, quantize=quantize)
    _assert_same_tables(jtabs, ttabs, quantize)
    user = ttabs["user_emb"]
    assert user.capacity > loaded_capacity             # the delta grew it
    if quantize:
        assert user is before                          # updated in place
    got = (tquant.lookup_or_zeros(user, _tenc(upd)) if quantize
           else tkv.lookup_or_zeros(user, _tenc(upd)))
    tol = np.abs(rows).max(axis=1, keepdims=True) / 254.0 if quantize else 0
    assert (np.abs(got.numpy() - rows) <= tol * (1 + QUANT_SLACK)).all()
    assert not bool(tkv.find(user, _tenc(ids[30:33])).found.any())


def _port_table(rng, n):
    """A port table of ``n`` random rows (no JAX work)."""
    t = tkv.create(DIM, 256, init_pool_rows=50, device="cpu")
    return tkv.insert(t, _tenc(rng.randint(1, 1 << 40, n)),
                      torch.from_numpy(rng.randn(n, DIM).astype(np.float32)))


def test_refresh_flag_must_match_the_table_type(tmp_path):
    tt = _port_table(np.random.RandomState(3), 20)
    d = str(tmp_path / "srv")
    tserving.export_for_serving(d, {"user_emb": tt}, _metadata(tserving, False))
    tckpt.save(str(tmp_path / "delta"), {"user_emb": tt}, delta=True)
    tabs, _ = tserving.load_for_serving(d, quantize=True, device="cpu")
    with pytest.raises(ValueError, match="quantize=True"):
        tserving.refresh_from_delta(tabs, str(tmp_path / "delta"))
    tabs, _ = tserving.load_for_serving(d, device="cpu")
    with pytest.raises(ValueError, match="quantize=False"):
        tserving.refresh_from_delta(tabs, str(tmp_path / "delta"),
                                    quantize=True)


def test_tfplus_format_is_refused(tmp_path):
    """``format="tfplus"`` writes a TensorFlow TensorBundle through the
    port's own writer, to local directories only: a ``scheme://``
    directory is refused, as the JAX package refuses it, before anything
    is written. (The export itself is held against the JAX package's in
    ``test_torch_tf_bridge.py``.)"""
    from tfplus_tpu_torch.io import get_filesystem
    tt = _port_table(np.random.RandomState(4), 10)
    with pytest.raises(ValueError, match="local directory"):
        tserving.export_for_serving("ram://srv_tfplus", {"user_emb": tt},
                                    _metadata(tserving, False),
                                    format="tfplus")
    fs, path = get_filesystem("ram://srv_tfplus")
    assert not fs.exists(path)
    assert not fs.exists(path + "/rank_service_embedding.json")
    d = tmp_path / "srv"
    prefix = tserving.export_for_serving(str(d), {"user_emb": tt},
                                         _metadata(tserving, False),
                                         format="tfplus")
    assert os.path.exists(prefix + ".index")
    assert not os.path.exists(prefix + ".index.json")
