"""Port parity for the host-DRAM storage tier (``kv/storage.py``).

Bit for bit against the JAX package: the host tier's put, take, delete and
arena growth (its arrays, free list and index), and, on tables that start
from one state, every table array and the tier after each spill (by
frequency, age and a live-row budget), prefetch and optimizer step, the
hybrid exports (full and delta) and ``restore_hybrid_split``. Then the
``HybridTable`` protocol with the asynchronous prefetch against a table
that never spills: the same rows per key, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import kv as jkv
from tfplus_tpu import optim as joptim
from tfplus_tpu.kv import storage as jstorage
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import optim as toptim
from tfplus_tpu_torch.kv import storage as tstorage
from test_torch_table import assert_same_table, to_port

DIM = 4
N = 32                 # ids per step: one shape, one JAX compile per op
STATE_TOL = dict(atol=2e-5, rtol=1e-4)   # test_torch_train.py states why


def _same_tier(a, b):
    for k in ("_keys", "_payload", "_meta"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        assert getattr(a, k).dtype == getattr(b, k).dtype, k
    for k in ("_keys", "_state", "_vals"):
        np.testing.assert_array_equal(getattr(a._index, k),
                                      getattr(b._index, k), k)
    assert (a._index.live, a._index._used, a._index._cap) == \
        (b._index.live, b._index._used, b._index._cap)
    assert a._free == b._free
    assert a.stats() == b.stats()


def test_host_tier_ops_match_jax():
    rng = np.random.RandomState(0)
    jt, tt = jstorage.HostStorageTier(DIM, 6), tstorage.HostStorageTier(DIM, 6)

    def both(fn):
        a, b = fn(jt), fn(tt)
        if a is not None:
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x, y)
        _same_tier(jt, tt)

    keys = rng.permutation(np.unique(rng.randint(0, 1 << 40, 1600)))[
        :1500].astype(np.uint64)
    pay = rng.randn(1500, 6).astype(np.float32)
    meta = rng.randint(0, 2**32, 1500, dtype=np.int64).astype(np.uint32)
    both(lambda t: t.put(keys, pay, meta))              # arena 1024 -> 2048
    dup = np.concatenate([keys[:10], keys[:5]])          # upsert, duplicates
    both(lambda t: t.put(dup, np.ones((15, 6), np.float32),
                         np.arange(15, dtype=np.uint32)))
    probe = np.concatenate([keys[100:140], np.arange(5, dtype=np.uint64)])
    both(lambda t: t.take(probe))
    both(lambda t: t.take(np.concatenate([keys[200:210], keys[200:210]])))
    both(lambda t: t.delete(keys[300:350]))
    both(lambda t: t.put(keys[100:130], pay[:30], meta[:30]))   # recycled
    both(lambda t: t.lookup_rows(probe))
    both(lambda t: t.ensure_width(9))
    both(lambda t: t.clear_touch_bits(np.uint32(1 << 30)))
    both(lambda t: t.live_rows())
    assert (int(keys[0]) in tt) and (1 not in tt)
    small = tstorage.HostStorageTier(DIM, capacity=3)
    small.put(keys[:3], pay[:3, :DIM], meta[:3])
    with pytest.raises(RuntimeError):
        small.put(keys[3:5], pay[3:5, :DIM], meta[3:5])


def test_index_matches_jax_under_churn():
    rng = np.random.RandomState(1)
    a, b = jstorage._NpIndex(64), tstorage._NpIndex(64)
    ref = {}
    for _ in range(30):
        k = np.unique(rng.randint(0, 500, 40).astype(np.uint64))
        v = rng.randint(0, 1 << 30, len(k))
        a.put(k, v)
        b.put(k, v)
        ref.update(zip(k.tolist(), v.tolist()))
        gone = rng.randint(0, 500, 20).astype(np.uint64)
        fa, va = a.pop(gone)
        fb, vb = b.pop(gone)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va, vb)
        for x in gone[fb].tolist():
            ref.pop(x)
    q = np.arange(500, dtype=np.uint64)
    found, vals = b.get(q)
    assert {int(x): int(y) for x, y in zip(q[found], vals[found])} == ref
    np.testing.assert_array_equal(np.sort(a.values()), np.sort(b.values()))


def _pair_tables(seed, capacity=256):
    pool = (np.random.RandomState(seed).randn(64, DIM) * 0.05).astype(
        np.float32)
    jopt = joptim.SparseOptimizer(joptim.rules.Adam())
    topt = toptim.SparseOptimizer(toptim.rules.Adam())
    jt = jopt.init(jkv.create(DIM, capacity, initializer=jnp.asarray(pool)))
    return jopt, topt, jt, to_port(jt)


def _same_export(a, b):
    assert sorted(k for k in a if k != "table") == \
        sorted(k for k in b if k != "table")
    for k in a:
        if k != "table":
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          k)


def test_spill_prefetch_export_and_restore_match_jax():
    rng = np.random.RandomState(2)
    jopt, topt, jt, tt = _pair_tables(3, capacity=128)

    @jax.jit
    def jstep(table, q, cnt, s):
        r = jkv.lookup_or_insert(table, q, cnt, day=s)
        return jopt.apply(r.table, r.slot, r.rows * 0.1, lr=0.1, step=s)

    jtier = jstorage.HostStorageTier(DIM, jt.payload.shape[1])
    ttier = tstorage.HostStorageTier(DIM, tt.payload.shape[1])
    policies = [dict(max_live=40), dict(min_freq=3),
                dict(older_than_days=1, day=4), dict(max_live=30)]
    for s, policy in enumerate(policies, start=1):
        raw = rng.permutation(np.unique(rng.randint(0, 160, 3 * N)))[
            :N].astype(np.int64)
        raw = np.concatenate([raw, rng.randint(1 << 41, 1 << 42,
                                               N - len(raw))])
        jt, jn = jstorage.prefetch(jt, jtier, raw)
        tt2, tn = tstorage.prefetch(tt, ttier, raw)
        assert jn == tn
        tt = tt2
        assert_same_table(jt, tt)
        _same_tier(jtier, ttier)
        cnt = rng.randint(1, 4, N).astype(np.int32)
        jt = jstep(jt, jkv.encode_ids_np_to_device(raw), jnp.asarray(cnt), s)
        tr = tkv.lookup_or_insert(tt, tkv.encode_ids_np_to_device(raw, "cpu"),
                                  torch.from_numpy(cnt), day=s)
        topt.apply(tt, tr.slot, tr.rows * 0.1, lr=0.1, step=s)
        # the two optimizers round alike only within STATE_TOL: carry the
        # JAX payload over, so that the tier moves start from equal bits
        np.testing.assert_array_equal(tt.header.numpy(), np.asarray(jt.header))
        np.testing.assert_allclose(tt.payload.numpy(), np.asarray(jt.payload),
                                   **STATE_TOL)
        tt.payload.copy_(torch.from_numpy(np.array(jt.payload)))
        jt, jn = jstorage.spill(jt, jtier, **policy)
        out, tn = tstorage.spill(tt, ttier, **policy)
        assert out is tt and jn == tn
        assert_same_table(jt, tt)
        _same_tier(jtier, ttier)
    assert ttier.size > 0
    for kw in (dict(), dict(delta=True), dict(enable_cutoff=True,
                                              cutoff_value=0.02)):
        jex = jstorage.export_hybrid_arrays(jt, jtier, **kw)
        tex = tstorage.export_hybrid_arrays(tt, ttier, **kw)
        _same_export(jex, tex)
        jt = jex["table"]
        assert_same_table(jt, tt)
        _same_tier(jtier, ttier)
    ex = tstorage.export_hybrid_arrays(tt, ttier)
    slots = {"opt_state": ex["slot-opt_state"]}
    _, _, jtemplate, ttemplate = _pair_tables(4)
    jtier2 = jstorage.HostStorageTier(DIM, DIM)
    ttier2 = tstorage.HostStorageTier(DIM, DIM)
    jr = jstorage.restore_hybrid_split(jtemplate, jtier2, ex, max_live=15,
                                       slots=slots)
    tr = tstorage.restore_hybrid_split(ttemplate, ttier2, ex, max_live=15,
                                       slots=slots)
    assert_same_table(jr, tr)
    _same_tier(jtier2, ttier2)
    _same_export(jstorage.export_hybrid_arrays(jr, jtier2),
                 tstorage.export_hybrid_arrays(tr, ttier2))


def _by_key(ex, names):
    order = np.argsort(ex["keys"])
    return {k: np.asarray(ex[k])[order] for k in names}


def test_hybrid_table_keeps_training_across_spills():
    """The HybridTable protocol (prefetch, step, asynchronous prefetch of
    the next batch, apply it, spill to a budget) against a table that never
    spills: the device holds at most the budget after every spill, the
    logical size is every id seen, and the rows per key are the same bits;
    the hybrid export restores into a fresh template and tier with the same
    rows."""
    rng = np.random.RandomState(5)
    jopt, topt, jt, tt = _pair_tables(6, capacity=256)
    ht = tstorage.HybridTable(tt, max_live=48)
    twin = to_port(jopt.init(jkv.create(DIM, 1024, initializer=jnp.asarray(
        jt.init_pool))))
    stream = [np.unique((rng.zipf(1.3, 3 * N) % 150).astype(np.int64))[:N]
              for _ in range(9)]
    seen = set()
    moved = []
    for s, ids in enumerate(stream[:-1], start=1):
        seen.update(ids.tolist())
        moved.append(ht.prefetch(ids))
        for table in (ht.table, twin):
            r = tkv.lookup_or_insert(
                table, tkv.encode_ids_np_to_device(ids, "cpu"), day=s)
            topt.apply(table, r.slot, r.rows * 0.1, lr=0.1, step=s)
        ht.prefetch_async(stream[s])
        with pytest.raises(RuntimeError):
            ht.prefetch_async(stream[s])
        moved.append(ht.apply_prefetch())
        ht.maybe_spill()
        assert int(tkv.size(ht.table)) <= 48
    assert sum(moved) > 0
    assert ht.logical_size == len(seen) == ht.stats()["logical_size"]
    names = ("keys", "values", "freq_values", "slot-opt_state")
    hyb = tstorage.export_hybrid_arrays(ht.table, ht.tier)
    want = tkv.export_arrays(twin)
    want["slot-opt_state"] = tkv.get_slot(twin, "opt_state")[
        tkv.find(twin, tkv.encode_ids_np_to_device(want["keys"], "cpu")
                 ).slot.long()].numpy()
    got, want = _by_key(hyb, names), _by_key(want, names)
    for k in names:
        np.testing.assert_array_equal(got[k], want[k], k)
    tier2 = tstorage.HostStorageTier(DIM, DIM)
    _, _, _, template = _pair_tables(6, capacity=64)
    back = tstorage.restore_hybrid_split(
        template, tier2, hyb, max_live=30,
        slots={"opt_state": hyb["slot-opt_state"]})
    again = _by_key(tstorage.export_hybrid_arrays(back, tier2), names)
    for k in names:
        np.testing.assert_array_equal(again[k], got[k], k)
    # promoting every spilled row grows the 64-row table
    n = tier2.size
    grown, moved = tstorage.prefetch(back, tier2, tier2.live_rows()[0])
    assert moved == n and grown.capacity > 64 and tier2.size == 0
    final = _by_key(tkv.export_arrays(grown), ("keys", "values"))
    for k in ("keys", "values"):
        np.testing.assert_array_equal(final[k], got[k], k)


def test_async_prefetch_drain_returns_rows():
    _, _, _, tt = _pair_tables(7)
    ht = tstorage.HybridTable(tt, max_live=0)
    ids = np.arange(1, N + 1, dtype=np.int64)
    tkv.lookup_or_insert(ht.table, tkv.encode_ids_np_to_device(ids, "cpu"))
    assert ht.maybe_spill() == N and int(tkv.size(ht.table)) == 0
    pf = tstorage.AsyncPrefetcher(ht.tier)
    pf.submit(tkv.encode_ids_np_to_device(ids[:10], "cpu"))
    assert pf.drain() == 10
    assert ht.tier.size == N and pf.drain() == 0
    pf.submit(ids[:10].astype(np.uint64))
    table, n = pf.apply(ht.table)
    assert n == 10 and int(tkv.size(table)) == 10 and ht.tier.size == N - 10


def test_bf16_tier_holds_jax_bytes_and_rows_bit_for_bit():
    """A bfloat16 table's host tier keeps each spilled row as its 16-bit
    pattern: its bytes equal the JAX tier's (ml_dtypes bfloat16), and the
    spilled rows, the tables after a spill and after the prefetch, and
    the hybrid export match JAX bit for bit."""
    rng = np.random.RandomState(4)
    jt = joptim.SparseOptimizer(joptim.rules.Adagrad()).init(
        jkv.create(DIM, 256, seed=1, value_dtype=jnp.bfloat16))
    keys = rng.permutation(np.unique(rng.randint(0, 1 << 40, 80)))[
        :64].astype(np.int64)
    w = jt.payload.shape[1]
    jt = jkv.insert(jt, jkv.encode_ids_np_to_device(keys), jnp.asarray(
        rng.randn(64, DIM).astype(np.float32)).astype(jnp.bfloat16))
    tt = to_port(jt)
    jtier = jstorage.HostStorageTier(DIM, w, np.dtype(jt.config.value_dtype))
    ttier = tstorage.HostStorageTier(DIM, w, torch.bfloat16)
    jt, jn = jstorage.spill(jt, jtier, max_live=24)
    tt, tn = tstorage.spill(tt, ttier, max_live=24)
    assert jn == tn == 40
    assert ttier._payload.dtype == np.uint16
    assert ttier.nbytes == jtier.nbytes
    assert ttier.nbytes < jtier._keys.nbytes + jtier._meta.nbytes \
        + jtier._payload.size * 4
    np.testing.assert_array_equal(ttier._payload,
                                  jtier._payload.view(np.uint16))
    assert_same_table(jt, tt)
    je = jstorage.export_hybrid_arrays(jt, jtier)
    te = tstorage.export_hybrid_arrays(tt, ttier)
    for k in ("keys", "values", "meta", "slot-opt_state"):
        np.testing.assert_array_equal(te[k], np.asarray(je[k]), k)
    jt, jp = jstorage.prefetch(jt, jtier, keys)
    tt, tp = tstorage.prefetch(tt, ttier, keys)
    assert jp == tp == 40 and ttier.size == jtier.size == 0
    assert_same_table(jt, tt)
