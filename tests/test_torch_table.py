"""Port parity: the same op sequence on a JAX table and on the port's table
leaves bit-identical header, payload and deletion log after every op, with
the same results, sizes and stats. Modelled on test_fuzz_table.py; the tiny
``max_probes=4`` table overflows on purpose."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import kv as jkv
from tfplus_tpu_torch import convert
from tfplus_tpu_torch import kv as tkv

TORCH_DTYPE = {np.dtype(jnp.float32): torch.float32,
               np.dtype(jnp.bfloat16): torch.bfloat16,
               np.dtype(jnp.float16): torch.float16}


def port_config(cfg):
    return tkv.KvConfig(dim=cfg.dim, enter_threshold=cfg.enter_threshold,
                        max_probes=cfg.max_probes,
                        value_dtype=TORCH_DTYPE[np.dtype(cfg.value_dtype)],
                        name=cfg.name, slot_layout=cfg.slot_layout,
                        support_prediction_delta=cfg.support_prediction_delta)


def to_port(jt):
    arrays = {f: np.asarray(jax.device_get(getattr(jt, f)))
              for f in convert.TABLE_FIELDS}
    return convert.table_from_numpy(arrays, port_config(jt.config), "cpu")


def bits(x):
    """Exact bit pattern of a JAX array or a torch tensor, as int64."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        elif x.dtype == torch.float32:
            x = x.view(torch.int32)
        return x.numpy().astype(np.int64)
    a = np.asarray(jax.device_get(x))
    if a.dtype in (np.dtype(jnp.bfloat16), np.float16):
        a = a.view(np.int16)
    elif a.dtype == np.float32:
        a = a.view(np.int32)
    return a.astype(np.int64)


def assert_same_table(jt, tt):
    for f in convert.TABLE_FIELDS:
        np.testing.assert_array_equal(bits(getattr(jt, f)),
                                      bits(getattr(tt, f)), f)
    assert jt.config.slot_layout == tt.config.slot_layout
    assert int(jkv.size(jt)) == int(tkv.size(tt))
    assert jkv.table.stats(jt) == tkv.stats(tt)
    assert jkv.load_factor(jt) == tkv.load_factor(tt)
    assert jkv.needs_grow(jt, 5) == tkv.needs_grow(tt, 5)
    np.testing.assert_array_equal(np.asarray(jkv.occupied_mask(jt)),
                                  tkv.occupied_mask(tt).numpy())


def assert_same(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), what)


def keys(rng, n, universe):
    # fixed batch sizes keep JAX's per-shape compiles to the first step
    ids = rng.choice(universe, n, replace=False)
    return ids, jkv.encode_ids_np_to_device(ids), \
        tkv.encode_ids_np_to_device(ids, device="cpu")


def rows_pair(rng, n, dim, jdtype):
    r = rng.randn(n, dim).astype(np.float32)
    return jnp.asarray(r, jdtype), torch.from_numpy(r)


@pytest.mark.parametrize("seed,capacity,max_probes,slots,dtype", [
    (0, 64, 4, False, jnp.float32),
    (1, 64, 4, False, jnp.bfloat16),
    (2, 256, 16, True, jnp.float32),
    (3, 256, 32, True, jnp.bfloat16),
])
def test_op_sequence(seed, capacity, max_probes, slots, dtype):
    rng = np.random.RandomState(seed)
    dim = 8
    jt = jkv.create(dim, capacity, max_probes=max_probes, value_dtype=dtype,
                    init_pool_rows=50, seed=seed)
    # create(): from the same init pool, the port's empty table is the JAX one
    tt = tkv.create(dim, capacity, max_probes=max_probes,
                    value_dtype=TORCH_DTYPE[np.dtype(dtype)],
                    initializer=to_port(jt).init_pool, device="cpu")
    assert_same_table(jt, tt)
    if slots:
        jt = jkv.ensure_slots(jt, {"m": 1, "v": 2})
        tt = tkv.ensure_slots(tt, {"m": 1, "v": 2})
        assert_same_table(jt, tt)
    universe = np.unique(rng.randint(0, 1 << 40, 400, dtype=np.int64))
    universe[:5] |= 1 << 62                        # large high words
    overflowed = False
    for step in range(3):
        day = 10 + step
        # insert
        _, jq, tq = keys(rng, 40, universe)
        jr, tr = rows_pair(rng, jq.shape[0], dim, dtype)
        jt = jkv.insert(jt, jq, jr, day=day)
        tt = tkv.insert(tt, tq, tr, day=day)
        assert_same_table(jt, tt)
        # lookup_or_insert, with and without defer_meta
        for defer in (False, True):
            _, jq, tq = keys(rng, 40, universe)
            cnt = rng.randint(1, 5, jq.shape[0]).astype(np.int32)
            jres = jkv.lookup_or_insert(jt, jq, jnp.asarray(cnt), day=day,
                                        defer_meta=defer)
            tres = tkv.lookup_or_insert(tt, tq, torch.from_numpy(cnt),
                                        day=day, defer_meta=defer)
            jt, tt = jres.table, tres.table
            assert_same_table(jt, tt)
            for f in ("rows", "slot", "overflow", "payload_rows", "meta_rows"):
                assert_same(getattr(jres, f), getattr(tres, f), f)
            overflowed |= bool(tres.overflow)
        # insert_raw with exact meta words (bit 31 set on some)
        _, jq, tq = keys(rng, 20, universe)
        w = jt.payload.shape[1]
        jr, tr = rows_pair(rng, jq.shape[0], w, dtype)
        meta = rng.randint(0, 2**32, jq.shape[0], dtype=np.int64)
        jt = jkv.insert_raw(jt, jq, jr, jnp.asarray(meta.astype(np.uint32)))
        tt = tkv.insert_raw(tt, tq, tr, torch.from_numpy(meta))
        assert_same_table(jt, tt)
        # insert with blacklist + explicit freq
        _, jq, tq = keys(rng, 16, universe)
        jr, tr = rows_pair(rng, jq.shape[0], dim, dtype)
        black = rng.rand(jq.shape[0]) < 0.5
        freq = rng.randint(0, 70000, jq.shape[0])
        jt = jkv.insert(jt, jq, jr, day=day, blacklist=jnp.asarray(black),
                        freq=jnp.asarray(freq.astype(np.uint32)))
        tt = tkv.insert(tt, tq, tr, day=day, blacklist=torch.from_numpy(black),
                        freq=torch.from_numpy(freq))
        assert_same_table(jt, tt)
        # reads: known, unknown and reserved ids
        ids, jq, tq = keys(rng, 60, universe)
        extra = np.array([[-1, -1], [-2, -1], [123, 456]], np.int32)
        jq = jnp.concatenate([jq, jnp.asarray(extra)])
        tq = torch.cat([tq, torch.from_numpy(extra)])
        valid = rng.rand(jq.shape[0]) < 0.9
        assert_same(jkv.lookup_or_zeros(jt, jq), tkv.lookup_or_zeros(tt, tq))
        assert_same(jkv.lookup_or_zeros(jt, jq, jnp.asarray(valid)),
                    tkv.lookup_or_zeros(tt, tq, torch.from_numpy(valid)))
        assert_same(jkv.lookup_with_init(jt, jq),
                    tkv.lookup_with_init(tt, tq))
        jf, tf = jkv.find(jt, jq), tkv.find(tt, tq)
        for f in ("slot", "found", "insert_slot", "meta"):
            assert_same(getattr(jf, f), getattr(tf, f), f)
        # delete (tombstones + deletion log)
        _, jq, tq = keys(rng, 10, universe)
        jt, jdel = jkv.delete(jt, jq)
        tt, tdel = tkv.delete(tt, tq)
        assert_same(jdel, tdel)
        assert_same_table(jt, tt)
    if capacity == 64:
        assert overflowed, "the tiny table should overflow"


@pytest.mark.parametrize("clear", [True, False])
def test_import_arrays_from_jax_export(clear):
    rng = np.random.RandomState(5)
    dim = 4
    src = jkv.create(dim, 256, seed=1)
    ids = rng.permutation(np.unique(
        rng.randint(0, 1 << 33, 70, dtype=np.int64)))[:60]
    src = jkv.insert(src, jkv.encode_ids_np_to_device(ids),
                     jnp.asarray(rng.randn(60, dim).astype(np.float32)),
                     day=77, blacklist=jnp.asarray(rng.rand(60) < 0.2))
    data = jkv.export_arrays(src, as_of_unix_day=20000)
    dst_j = jkv.create(dim, 256, seed=2)
    dst_j = jkv.insert(dst_j, jkv.encode_ids_np_to_device(ids[:20] + 1),
                       jnp.ones((20, dim)), day=3)
    dst_t = to_port(dst_j)
    delete_keys = ids[:10] + 1                    # present only when not clear
    jt = jkv.import_arrays(dst_j, data, clear=clear, delete_keys=delete_keys)
    tt = tkv.import_arrays(dst_t, data, clear=clear, delete_keys=delete_keys)
    assert_same_table(jt, tt)


def test_import_that_needs_growth_raises():
    """Growth is ported: an import past what ``max_probes=8`` can place
    grows and re-inserts, places every row and leaves the JAX package's
    table bit for bit; only an import that four grows cannot place
    (``max_probes=1``) raises, as in the JAX package."""
    data = {"keys": np.arange(1, 171, dtype=np.int64),
            "values": np.arange(170 * 4, dtype=np.float32).reshape(170, 4)}
    jt = jkv.import_arrays(jkv.create(4, 256, max_probes=8, seed=0), data,
                           day=7)
    tt = tkv.import_arrays(to_port(jkv.create(4, 256, max_probes=8, seed=0)),
                           data, day=7)
    assert tt.capacity > 256 and int(tkv.size(tt)) == 170
    assert_same_table(jt, tt)
    with pytest.raises(RuntimeError, match="after 4 grows"):
        tkv.import_arrays(tkv.create(4, 256, max_probes=1, device="cpu"),
                          data)


def test_table_from_numpy_round_trip():
    jt = jkv.create(8, 128, seed=3, value_dtype=jnp.bfloat16)
    jt = jkv.lookup_or_insert(jt, jkv.encode_ids_np_to_device(
        np.arange(50, dtype=np.int64))).table
    tt = to_port(jt)
    assert tt.payload.dtype == torch.bfloat16 and tt.device.type == "cpu"
    assert_same_table(jt, tt)
    bad = dataclasses.replace(port_config(jt.config), dim=4)
    with pytest.raises(ValueError):
        convert.table_from_numpy(
            {f: np.asarray(getattr(jt, f)) for f in convert.TABLE_FIELDS},
            bad, "cpu")


def test_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tkv.create(8, 64)
