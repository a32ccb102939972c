"""Port parity: key encoding, hashing, routing and meta packing match the JAX
package bit for bit on random uint64 keys (sentinels and top-bit keys
included)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfplus_tpu.kv import hashing as jh
from tfplus_tpu.utils import packing as jp
from tfplus_tpu_torch.kv import hashing as th
from tfplus_tpu_torch.utils import packing as tp


def _keys_u64(seed, n=4096):
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 2**63, size=n, dtype=np.int64).astype(np.uint64)
    k[: n // 4] |= np.uint64(1 << 63)                  # top bit set
    k[n // 4: n // 2] &= np.uint64(0xFFFFFFFF)         # hi word 0
    k[-4:] = np.array([2**64 - 1, 2**64 - 2, 0, 2**63], np.uint64)
    return k


def _pair(seed, n=4096):
    k = _keys_u64(seed, n)
    return np.asarray(jh.encode_ids(k)), th.encode_ids(k, device="cpu")


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_decode(seed):
    k = _keys_u64(seed)
    jk, tk = np.asarray(jh.encode_ids(k)), th.encode_ids(k, device="cpu")
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(jk, tk.numpy())
    np.testing.assert_array_equal(th.decode_ids_np(tk), k)
    np.testing.assert_array_equal(jh.decode_ids_np(jk), th.decode_ids_np(jk))
    # int64 / int32 inputs, passthrough of encoded keys, raw 2-wide batches
    s = np.random.RandomState(seed).randint(-2**31, 2**31, 64).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(jh.encode_ids(s)),
                                  th.encode_ids(s, device="cpu").numpy())
    s32 = s.astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jh.encode_ids(s32)),
                                  th.encode_ids(s32, device="cpu").numpy())
    np.testing.assert_array_equal(th.encode_ids(tk).numpy(), jk)
    raw = s32.reshape(32, 2)
    np.testing.assert_array_equal(np.asarray(jh.encode_ids_raw(raw)),
                                  th.encode_ids_raw(raw, device="cpu").numpy())
    np.testing.assert_array_equal(
        np.asarray(jh.encode_ids_np_to_device(s32)),
        th.encode_ids_np_to_device(s32, device="cpu").numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_sentinel_predicates(seed):
    jk, tk = _pair(seed)
    for name in ("is_empty", "is_tombstone", "is_free", "is_reserved_id"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)(jk)),
                                      getattr(th, name)(tk).numpy(), name)
    assert th.is_empty(tk).sum() == 1 and th.is_tombstone(tk).sum() == 1
    np.testing.assert_array_equal(
        np.asarray(jh.keys_equal(jk, jk[::-1])),
        th.keys_equal(tk, tk.flip(0)).numpy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("hseed", [0, 0x2545F491, 0x6A09E667, 0xFFFFFFFF])
def test_hash_words(seed, hseed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(_np(jh.hash_words(jk, hseed)),
                                  th.hash_words(tk, hseed).numpy())
    words = np.random.RandomState(seed).randint(
        0, 2**32, 4096, dtype=np.int64).astype(np.uint32)
    np.testing.assert_array_equal(
        _np(jh._fmix32(jnp.asarray(words))),
        th._fmix32(torch.from_numpy(words.astype(np.int64))).numpy())


@pytest.mark.parametrize("capacity", [32, 1024, 1 << 20])
def test_bucket_choices(capacity):
    jk, tk = _pair(capacity)
    jb1, jb2 = jh.bucket_choices(jk, capacity)
    tb1, tb2 = th.bucket_choices(tk, capacity)
    np.testing.assert_array_equal(_np(jb1), tb1.numpy())
    np.testing.assert_array_equal(_np(jb2), tb2.numpy())
    assert (tb1 != tb2).all()


@pytest.mark.parametrize("num_shards", [1, 4, 6, 7])
def test_shard_of(num_shards):
    jk, tk = _pair(num_shards)
    got = th.shard_of(tk, num_shards).numpy()
    np.testing.assert_array_equal(_np(jh.shard_of(jk, num_shards)), got)
    if num_shards in (1, 4):   # exact key % N where the 32-bit form is exact
        np.testing.assert_array_equal(
            got, (_keys_u64(num_shards) % np.uint64(num_shards)).astype(
                np.int64))


@pytest.mark.parametrize("pool", [7, 1024, 10000])
def test_init_row_indices(pool):
    jk, tk = _pair(pool)
    for j, t in zip(jh.init_row_indices(jk, pool),
                    th.init_row_indices(tk, pool)):
        np.testing.assert_array_equal(_np(j), t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_packing(seed):
    rng = np.random.RandomState(seed)
    n = 2048
    meta = rng.randint(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    meta[:4] = [0, 0xFFFFFFFF, 1 << 31, 0xFFFF]
    freq = rng.randint(0, 2**17, n).astype(np.uint32)
    day = rng.randint(0, 2**16, n).astype(np.uint32)
    add = rng.randint(0, 2**16, n).astype(np.uint32)
    tm = torch.from_numpy(meta.astype(np.int64))
    tf, td = (torch.from_numpy(a.astype(np.int64)) for a in (freq, day))
    np.testing.assert_array_equal(
        _np(jp.pack(jnp.asarray(freq), jnp.asarray(day), jnp.asarray(meta))),
        tp.pack(tf, td, tm).numpy())
    for name in ("get_freq", "get_day", "get_flags"):
        np.testing.assert_array_equal(_np(getattr(jp, name)(jnp.asarray(meta))),
                                      getattr(tp, name)(tm).numpy(), name)
    np.testing.assert_array_equal(
        _np(jp.saturating_add_freq(jnp.asarray(meta), jnp.asarray(add), 4321)),
        tp.saturating_add_freq(tm, torch.from_numpy(add.astype(np.int64)),
                               4321).numpy())
    for name in ("FLAG_BLACKLIST", "FLAG_TOUCH_TRAIN", "FLAG_TOUCH_PRED",
                 "FLAG_TOUCH_BOTH", "FREQ_MASK", "DAY_MASK", "FLAGS_MASK"):
        assert int(getattr(jp, name)) == getattr(tp, name), name
    assert abs(jp.current_day() - tp.current_day()) <= 1
