"""Port parity for the API surface: the configuration classes (field by
field against the JAX package's, from the same environment) and the
variable store (create or fetch, shards named ``name/part_i`` and seeded
``seed + i``, partitioner objects and TF-style closures, feature sizes, the
saver-mode switches, the package-level names)."""
import dataclasses

import numpy as np
import pytest
import torch

import tfplus_tpu
import tfplus_tpu_torch
from tfplus_tpu import config as jconfig
from tfplus_tpu import kv as jkv
from tfplus_tpu import variables as jvariables
from tfplus_tpu_torch import config as tconfig
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import variables as tvariables
from tfplus_tpu_torch.checkpoint import saver as tsaver
from test_torch_table import assert_same_table

# RuntimeConfig fields that steer the JAX package alone: the Pallas row ops
# switch (the port always runs its CUDA row kernel on a CUDA tensor) and
# XLA's persistent compilation cache. The port leaves them out on purpose.
JAX_ONLY_FIELDS = {"enable_pallas_rowops", "compile_cache_dir"}

ENV = ("TFPLUS_TPU_INFERENCE_ONLY", "SUPPORT_DELTA_EXPORT",
       "SUPPORT_PREDICTION_DELTA_EXPORT", "TFPLUS_TPU_ENABLE_PALLAS_ROWOPS",
       "TFPLUS_TPU_COMPILE_CACHE")


def _plain(v):
    """A default as plain data: a nested config as its dict of fields."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _fields(cls):
    return {f.name: _plain(f.default if f.default is not dataclasses.MISSING
                           else f.default_factory())
            for f in dataclasses.fields(cls)}


def test_config_classes_match_jax_field_by_field():
    for name in ("StorageType", "StorageCombination"):
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        assert [(m.name, int(m)) for m in j] == [(m.name, int(m)) for m in t]
    for name in ("KvStorageConfig", "KvOptions"):
        assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))
    jf, tf = _fields(jconfig.RuntimeConfig), _fields(tconfig.RuntimeConfig)
    assert set(jf) - set(tf) == JAX_ONLY_FIELDS
    assert {k: v for k, v in jf.items() if k not in JAX_ONLY_FIELDS} == tf
    opts = tconfig.KvOptions(enter_threshold=5, ttl_days=30)
    assert opts.storage.combination == tconfig.StorageCombination.MEM
    with pytest.raises(dataclasses.FrozenInstanceError):
        opts.ttl_days = 1


@pytest.mark.parametrize("env", [
    {},
    {"SUPPORT_DELTA_EXPORT": "0", "TFPLUS_TPU_INFERENCE_ONLY": "1"},
    {"SUPPORT_DELTA_EXPORT": "false", "SUPPORT_PREDICTION_DELTA_EXPORT": "yes",
     "TFPLUS_TPU_ENABLE_PALLAS_ROWOPS": "1"},
    {"TFPLUS_TPU_INFERENCE_ONLY": "", "SUPPORT_DELTA_EXPORT": "False"},
])
def test_runtime_config_from_the_same_environment(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = dataclasses.asdict(jconfig.RuntimeConfig.from_env())
    t = dataclasses.asdict(tconfig.RuntimeConfig.from_env())
    assert {k: v for k, v in j.items() if k not in JAX_ONLY_FIELDS} == t
    monkeypatch.setattr(tconfig, "_runtime", None)
    assert tconfig.runtime() is tconfig.runtime()
    assert dataclasses.asdict(tconfig.runtime()) == t


def _pool(dim, rows=20, seed=0):
    return np.random.RandomState(seed).randn(rows, dim).astype(np.float32)


def test_store_creates_and_fetches_like_jax():
    """With an explicit initializer array, the port's table is the JAX
    store's, bit for bit, and so are both after the same lookups."""
    js, ts = jvariables.KvVariableStore(), tvariables.KvVariableStore()
    pool = _pool(16)
    jt = js.get_kv_variable("emb_a", 16, capacity=64, initializer=pool,
                            enter_threshold=2)
    tt = ts.get_kv_variable("emb_a", 16, capacity=64, initializer=pool,
                            enter_threshold=2, device="cpu")
    assert_same_table(jt, tt)
    assert tt.config.name == "emb_a" and tt.config.enter_threshold == 2
    assert ts.get_kv_variable("emb_a", 16) is tt
    with pytest.raises(ValueError, match="dim mismatch"):
        ts.get_kv_variable("emb_a", 32)
    ids = np.arange(5, dtype=np.int64)
    js.update("emb_a", jkv.lookup_or_insert(
        jt, jkv.encode_ids_np_to_device(ids)).table)
    tkv.lookup_or_insert(tt, tkv.encode_ids_np_to_device(ids, "cpu"))
    assert_same_table(js["emb_a"], ts["emb_a"])
    assert ts.get_kv_feature_size() == js.get_kv_feature_size() == {"emb_a": 5}
    assert "emb_a" in ts and list(ts.tables()) == ["emb_a"]


def _tf_like_partitioner(shape=None, dtype=None, num_shards=3, axis=0):
    """The shape of ``tf.fixed_size_partitioner(3)``'s closure."""
    parts = [1] * shape.ndims
    parts[axis] = min(num_shards, shape.dims[axis].value)
    return parts


def _keywordless(s, d):
    """A closure that takes its arguments by position only."""
    return [min(3, s.dims[0].value), 1]


@pytest.mark.parametrize("how", ["num_shards", "object", "closure",
                                 "keywordless"])
def test_store_shards_match_jax(how):
    """Shards are named ``name/part_i`` and seeded ``seed + i`` (so each has
    its own default init pool); a partitioner, whichever form, overrides
    ``num_shards``."""
    kw = {"num_shards": dict(num_shards=3),
          "object": dict(partitioner=tvariables.fixed_size_partitioner(3)),
          "closure": dict(partitioner=_tf_like_partitioner),
          "keywordless": dict(partitioner=_keywordless)}[how]
    jkw = dict(kw)
    if how == "object":
        jkw["partitioner"] = jvariables.fixed_size_partitioner(3)
    pool = _pool(4)
    js, ts = jvariables.KvVariableStore(), tvariables.KvVariableStore()
    jshards = js.get_kv_variable("big", 4, capacity=64, initializer=pool,
                                 seed=5, **jkw)
    tshards = ts.get_kv_variable("big", 4, capacity=64, initializer=pool,
                                 seed=5, device="cpu", **kw)
    assert [t.config.name for t in tshards] == [
        "big/part_0", "big/part_1", "big/part_2"]
    for a, b in zip(jshards, tshards):
        assert_same_table(a, b)
    # default pools: one seed per shard
    ts2 = tvariables.KvVariableStore().get_kv_variable(
        "big", 4, capacity=64, num_shards=2, seed=5, device="cpu")
    want = [tkv.create(4, 64, seed=s, device="cpu").init_pool for s in (5, 6)]
    assert all(torch.equal(t.init_pool, w) for t, w in zip(ts2, want))
    with pytest.raises(ValueError, match="partitioner"):
        ts.get_kv_variable("bad", 4, partitioner=object())


def test_saver_mode_and_package_names():
    store = tvariables.KvVariableStore()
    assert store.save_first_n == tsaver.FIRST_N_TRAIN
    store.set_saver_mode(0)
    assert store.save_first_n == tsaver.FIRST_N_INFERENCE
    store.set_training(False)
    assert not store.is_training
    for name in ("get_kv_variable", "get_kv_feature_size",
                 "fixed_size_partitioner", "set_tfplus_saver_mode",
                 "tfplus_saver_mode", "KvVariableStore", "default_store"):
        assert hasattr(tfplus_tpu, name)
        assert getattr(tfplus_tpu_torch, name) is getattr(tvariables, name)
    default = tfplus_tpu_torch.default_store()
    mode = tfplus_tpu_torch.tfplus_saver_mode()
    try:
        tfplus_tpu_torch.set_tfplus_saver_mode(0)
        assert tfplus_tpu_torch.tfplus_saver_mode() == 0 == default.saver_mode
    finally:
        tfplus_tpu_torch.set_tfplus_saver_mode(mode)
    t = tfplus_tpu_torch.get_kv_variable("api_test_default", 4, capacity=64,
                                         device="cpu")
    assert default["api_test_default"] is t
    assert tfplus_tpu_torch.get_kv_feature_size()["api_test_default"] == 0
