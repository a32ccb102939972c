"""Port parity for the TensorFlow bridge: the port's own TensorBundle reader
and writer (``checkpoint.tf_bundle``) held against TensorFlow, and its
``tf_import`` / ``tf_export`` / ``export_for_serving(format="tfplus")``
against the JAX package's, which go through TensorFlow.

The fixture checkpoints are written by TensorFlow itself (``SaveV2`` and
``MergeV2Checkpoints``): a plain KV variable, a 2-shard one with uint16
freqs and a blacklist, a SaveV3 packed-uint32 one, a k=2 slot variable, a
dense tensor, a bfloat16 tensor, a string tensor, a tensor saved in two
slices, and a bundle of two data shards. Integer state (headers, keys,
meta words) must match the JAX package bit for bit, and the values too:
both import the same float32 bytes. Bundles the port writes must be the
bytes ``SaveV2`` writes for the same names and arrays."""
import os
import re
import shutil

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfplus_tpu import kv as jkv  # noqa: E402
from tfplus_tpu import serving as jserving  # noqa: E402
from tfplus_tpu.checkpoint import tf_export as jexport  # noqa: E402
from tfplus_tpu.checkpoint import tf_import as jimport  # noqa: E402
from tfplus_tpu_torch import kv as tkv  # noqa: E402
from tfplus_tpu_torch import serving as tserving  # noqa: E402
from tfplus_tpu_torch.checkpoint import crc32c  # noqa: E402
from tfplus_tpu_torch.checkpoint import tf_bundle  # noqa: E402
from tfplus_tpu_torch.checkpoint import tf_export as texport  # noqa: E402
from tfplus_tpu_torch.checkpoint import tf_import as timport  # noqa: E402
from tfplus_tpu_torch.convert import TABLE_FIELDS  # noqa: E402
from test_torch_table import assert_same, assert_same_table, to_port  # noqa: E402,E501

DATA = ".data-00000-of-00001"
DAY = 20100                        # as_of_unix_day of every export


def _save_v2(prefix, names, tensors, slices=None):
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=slices or [""] * len(names),
                      tensors=[tf.constant(t) for t in tensors])


def _fixture_tensors():
    """The reference-format tensors of ``tests/test_tf_import.py``'s
    fixture, plus a bfloat16 and a string tensor."""
    rng = np.random.RandomState(0)
    emb_keys = np.array([3, 11, 2**40, 7], np.int64)
    k0, k1 = np.array([2, 4, 10], np.int64), np.array([1, 3, 9], np.int64)
    u_keys = np.array([21, 22], np.int64)
    out = [
        ("emb-keys", emb_keys),
        ("emb-values", rng.randn(4, 8).astype(np.float32)),
        ("emb-init_table", rng.randn(16, 8).astype(np.float32)),
        ("emb-blacklist", np.zeros((0,), np.int64)),
        ("emb-freq_keys", emb_keys),
        ("emb-freq_values", np.array([1, 2, 3, 4], np.uint16)),
    ]
    for part, (k, f, bl) in enumerate([
            (k0, [5, 6, 7], np.zeros((0,), np.int64)),
            (k1, [8, 9, 10], np.array([3], np.int64))]):
        base = f"wide/part_{part}"
        out += [(base + "-keys", k),
                (base + "-values", rng.randn(3, 4).astype(np.float32)),
                (base + "-init_table", np.zeros((0, 4), np.float32)),
                (base + "-blacklist", bl),
                (base + "-freq_keys", k),
                (base + "-freq_values", np.array(f, np.uint16))]
    out += [
        ("packed-keys", u_keys),
        ("packed-values", rng.randn(2, 4).astype(np.float32)),
        ("packed-freq_keys", u_keys),
        ("packed-freq_values",
         np.array([17, 900], np.uint32)
         | (np.array([20000, 20001], np.uint32) << 16)),
        ("emb/m_v-keys", emb_keys),
        ("emb/m_v-values", rng.randn(4, 16).astype(np.float32)),
        ("dense/w", np.arange(6, dtype=np.float32).reshape(2, 3)),
        ("dense/bf16", tf.constant(rng.randn(3, 5), tf.bfloat16).numpy()),
        ("dense/strings", np.array([b"ab", b"", b"xyz" * 50, b"\x00\xff"],
                                   object)),
        ("dense/u64", np.array([2**63 + 5, 1], np.uint64)),
        ("dense/bool", np.array([[True], [False]])),
        ("dense/f16", np.arange(3, dtype=np.float16)),
        ("dense/scalar", np.float64(2.5)),
    ]
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("tfbridge")
    tensors = _fixture_tensors()
    names = [n for n, _ in tensors]
    arrays = [a for _, a in tensors]
    plain = str(root / "plain" / "model.ckpt-100")
    _save_v2(plain, names, arrays)
    # a TF1 partitioned dense variable: one tensor saved as two slices
    sliced = str(root / "sliced" / "model.ckpt-1")
    w = np.arange(30, dtype=np.float32).reshape(6, 5)
    _save_v2(sliced, ["part/w", "part/w", "emb-keys"],
             [w[:4], w[4:], np.array([1], np.int64)],
             ["6 5 0,4:-", "6 5 4,2:-", ""])
    # a bundle of two data shards, as MergeV2Checkpoints leaves it
    half = len(names) // 2
    parts = [str(root / f"p{i}" / "part") for i in range(2)]
    _save_v2(parts[0], names[:half], arrays[:half])
    _save_v2(parts[1], names[half:], arrays[half:])
    merged = str(root / "merged" / "model.ckpt-100")
    os.makedirs(os.path.dirname(merged))
    tf.raw_ops.MergeV2Checkpoints(checkpoint_prefixes=parts,
                                  destination_prefix=merged)
    return {"root": root, "plain": plain, "sliced": sliced, "merged": merged,
            "names": names, "arrays": arrays, "w": w}


def assert_same_import(j, t, pool=True):
    """Every field of the two tables bit for bit; a fresh table's init
    pool comes from each package's own generator, so it is compared only
    where the checkpoint gives one (``pool``)."""
    for f in TABLE_FIELDS:
        if pool or f != "init_pool":
            assert_same(getattr(j, f), getattr(t, f), f)
    assert j.config.slot_layout == t.config.slot_layout
    assert t.device.type == "cpu" and t.config.name == j.config.name


def _same_tensor(a, b, what):
    assert a.shape == b.shape, what
    if a.dtype == object:
        assert b.dtype == object and a.tolist() == b.tolist(), what
    else:
        assert a.dtype.itemsize == b.dtype.itemsize, what
        assert a.tobytes() == b.tobytes(), what


def _numpy_dtype(tf_dtype):
    if tf_dtype == tf.string:
        return np.dtype(object)
    if tf_dtype == tf.bfloat16:
        return tf_bundle.BFLOAT16
    return np.dtype(tf_dtype.as_numpy_dtype)


@pytest.mark.parametrize("which", ["plain", "merged", "sliced"])
def test_reader_equals_tensorflow(ckpt, which):
    prefix = ckpt[which]
    want = tf.train.load_checkpoint(prefix)
    got = tf_bundle.TFBundleReader(prefix)
    assert got.num_shards == (2 if which == "merged" else 1)
    shapes = want.get_variable_to_shape_map()
    assert got.get_variable_to_shape_map() == shapes
    dtypes = got.get_variable_to_dtype_map()
    assert dtypes == {n: _numpy_dtype(d) for n, d in
                      want.get_variable_to_dtype_map().items()}
    for name in shapes:
        assert got.has_tensor(name)
        _same_tensor(want.get_tensor(name), got.get_tensor(name), name)
    assert not got.has_tensor("nope")
    if which == "sliced":
        np.testing.assert_array_equal(got.get_tensor("part/w"), ckpt["w"])


def test_directory_prefix_resolves_like_tensorflow(ckpt):
    d = os.path.dirname(ckpt["plain"])
    with open(os.path.join(d, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "model.ckpt-100"\n')
    got = tf_bundle.TFBundleReader(d)
    assert got.prefix == ckpt["plain"]
    want = tf.train.load_checkpoint(d)
    _same_tensor(want.get_tensor("dense/w"), got.get_tensor("dense/w"), "w")


def test_list_kv_variables_equals_jax(ckpt):
    for which in ("plain", "merged"):
        want = jimport.list_kv_variables(ckpt[which])
        got = timport.list_kv_variables(ckpt[which])
        assert got == want
    assert set(got) == {"emb", "wide", "packed", "emb/m_v"}


@pytest.mark.parametrize("name,shards", [("emb", 1), ("wide", 1),
                                         ("wide", 3), ("packed", 1)])
def test_import_kv_variable_equals_jax(ckpt, name, shards):
    """Headers (keys and meta words), payloads and init pools bit for bit
    at the checkpoint's shard count and another."""
    want = jimport.import_kv_variable(ckpt["merged"], name,
                                      num_shards=shards, capacity=64)
    got = timport.import_kv_variable(ckpt["merged"], name,
                                     num_shards=shards, capacity=64,
                                     device="cpu")
    assert len(got) == len(want) == shards
    for j, t in zip(want, got):
        assert_same_import(j, t, pool=name == "emb")


def test_import_checkpoint_and_slot_rows_equal_jax(ckpt):
    prefix = ckpt["plain"]
    jt = {"emb": jkv.create(8, 64), "wide": [jkv.create(4, 64),
                                            jkv.create(4, 64)]}
    want = jimport.import_checkpoint(prefix, jt)
    got = timport.import_checkpoint(prefix, {
        "emb": to_port(jt["emb"]), "wide": [to_port(t) for t in jt["wide"]]})
    assert isinstance(got["wide"], list) and len(got["wide"]) == 2
    assert_same_table(want["emb"], got["emb"])
    for j, t in zip(want["wide"], got["wide"]):
        assert_same_table(j, t)
    # the k=2 concat slot into co-located slot columns
    js = jimport.attach_slot_rows(want["emb"], prefix, "emb/m_v", "m_v")
    ts = timport.attach_slot_rows(got["emb"], prefix, "emb/m_v", "m_v")
    assert ts.config.slot_layout == js.config.slot_layout == (("m_v", 2),)
    assert_same_table(js, ts)
    with pytest.raises(KeyError, match="nope"):
        timport.import_kv_variable(prefix, "nope", device="cpu")
    with pytest.raises(KeyError, match="nope"):
        timport.attach_slot_rows(ts, prefix, "nope", "m")


@pytest.mark.parametrize("name", ["dense/w", "dense/bf16", "dense/strings",
                                  "dense/u64", "part/w"])
def test_read_dense_equals_jax(ckpt, name):
    prefix = ckpt["sliced" if name == "part/w" else "merged"]
    _same_tensor(jimport.read_dense(prefix, name),
                 timport.read_dense(prefix, name), name)


def test_write_bundle_is_savev2_byte_for_byte(ckpt, tmp_path):
    """The fixture's tensors written by the port: the same .index and
    .data bytes as SaveV2's, and TensorFlow reads them back equal. The
    bfloat16 tensor goes in as ml_dtypes (as TF gives it), as the port
    reads it (2-byte void) and as a torch tensor."""
    ours = str(tmp_path / "ours" / "model.ckpt-100")
    assert tf_bundle.write_bundle(ours, ckpt["names"],
                                  iter(ckpt["arrays"])) == ours
    for suffix in (".index", DATA):
        with open(ckpt["plain"] + suffix, "rb") as f:
            want = f.read()
        with open(ours + suffix, "rb") as f:
            assert f.read() == want, suffix
    r = tf.train.load_checkpoint(ours)
    for name, arr in zip(ckpt["names"], ckpt["arrays"]):
        _same_tensor(np.asarray(r.get_tensor(name)), np.asarray(arr), name)
    bf = dict(zip(ckpt["names"], ckpt["arrays"]))["dense/bf16"]
    as_void = bf.view(np.uint16).view(tf_bundle.BFLOAT16)
    as_torch = torch.from_numpy(bf.view(np.int16).copy()).view(
        torch.bfloat16)
    for i, x in enumerate((as_void, as_torch)):
        p = str(tmp_path / f"bf{i}" / "ck")
        tf_bundle.write_bundle(p, ["x"], [x])
        got = tf.train.load_checkpoint(p).get_tensor("x")
        assert got.dtype == bf.dtype
        assert got.tobytes() == bf.tobytes()


def test_write_bundle_across_blocks_is_savev2_byte_for_byte(tmp_path):
    """Enough entries for two table blocks and many restarts, names that
    share and do not share prefixes, and empty tensors."""
    names = [f"t{i:05d}/{'x' * (i % 7)}-values" for i in range(6500)]
    arrays = [np.arange(i % 3, dtype=np.float32) for i in range(6500)]
    _save_v2(str(tmp_path / "tf"), names, arrays)
    tf_bundle.write_bundle(str(tmp_path / "ours"), names, arrays)
    for suffix in (".index", DATA):
        with open(str(tmp_path / "tf") + suffix, "rb") as a, \
                open(str(tmp_path / "ours") + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def _tables(seed, n_shards, dim=8):
    """The same random shards in both packages, 16 ids each (one negative):
    freqs, days, a blacklist and rows the cutoff drops; returns ``(jax
    shards, port shards)``."""
    rng = np.random.RandomState(seed)
    jt = []
    for s in range(n_shards):
        t = jkv.create(dim, 256, seed=seed * 10 + s, init_pool_rows=20)
        ids = rng.choice(10**5, 16, replace=False).astype(np.int64) \
            * n_shards + s
        if s == 0:
            ids[0] = -7 * n_shards
        rows = rng.randn(len(ids), dim).astype(np.float32)
        rows[:2] = 1e-30                     # cut by enable_cutoff
        t = jkv.insert(t, jkv.encode_ids_np_to_device(ids), jnp.asarray(rows),
                       freq=jnp.asarray(rng.randint(1, 60000, len(ids))
                                        .astype(np.uint32)),
                       blacklist=jnp.asarray(rng.rand(len(ids)) < 0.2),
                       day=20000 + seed)
        jt.append(t)
    return jt, [to_port(t) for t in jt]


@pytest.mark.parametrize("first_n,freq_u32,key_dtype,shards,cutoff", [
    (6, False, np.int64, 1, False),
    (6, True, np.uint64, 2, True),
    (3, False, np.int64, 2, False),
    (4, True, np.uint64, 1, False),
])
def test_export_checkpoint_equals_jax(tmp_path, first_n, freq_u32, key_dtype,
                                      shards, cutoff):
    """The same state exported by both packages: byte-identical files, so
    TensorFlow reads the same tensors; and each package's importer reads
    the other's export into the tables it makes of its own."""
    jt, tt = _tables(shards + first_n, shards)
    dense = {"dnn/w": np.eye(3, dtype=np.float32)}
    kw = dict(first_n=first_n, key_dtype=key_dtype, freq_use_uint32=freq_u32,
              enable_cutoff=cutoff, dense=dense, as_of_unix_day=DAY)
    pj, pt = str(tmp_path / "jax" / "ck"), str(tmp_path / "port" / "ck")
    arg = (lambda ts: ts if shards > 1 else ts[0])
    jexport.export_checkpoint(pj, {"emb": arg(jt)}, **kw)
    assert texport.export_checkpoint(pt, {"emb": arg(tt)}, **kw) == pt
    for suffix in (".index", DATA):
        with open(pj + suffix, "rb") as a, open(pt + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    rj, rt = tf.train.load_checkpoint(pj), tf.train.load_checkpoint(pt)
    assert rt.get_variable_to_shape_map() == rj.get_variable_to_shape_map()
    for name in rj.get_variable_to_shape_map():
        _same_tensor(rj.get_tensor(name), rt.get_tensor(name), name)
    # the tables are read, not changed
    for j, t in zip(jt, tt):
        assert_same_table(j, t)
    if shards == 2 and first_n == 6:
        want = jimport.import_kv_variable(pj, "emb", num_shards=3,
                                          capacity=64)
        cross = jimport.import_kv_variable(pt, "emb", num_shards=3,
                                           capacity=64)
        port = timport.import_kv_variable(pj, "emb", num_shards=3,
                                          capacity=64, device="cpu")
        for w, c, p in zip(want, cross, port):
            assert_same_table(w, to_port(c))
            assert_same_table(w, p)


def test_export_for_serving_tfplus_equals_jax(tmp_path):
    jt, tt = _tables(5, 2)
    jmd, tmd = jserving.RankingMetadata(), tserving.RankingMetadata()
    for md in (jmd, tmd):
        md.add_embedding_column(column_name="item", var_name="item_emb",
                                embedding_dim=8, num_shards=2)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    pj = jserving.export_for_serving(dj, {"item_emb": jt}, jmd,
                                     format="tfplus")
    pt = tserving.export_for_serving(dt, {"item_emb": tt}, tmd,
                                     format="tfplus")
    assert pt == dt + "/serving"
    rj, rt = tf.train.load_checkpoint(pj), tf.train.load_checkpoint(pt)
    shapes = rj.get_variable_to_shape_map()
    assert rt.get_variable_to_shape_map() == shapes
    assert "item_emb/part_1-init_table" in shapes
    assert "item_emb/part_0-blacklist" not in shapes
    for name in shapes:
        _same_tensor(rj.get_tensor(name), rt.get_tensor(name), name)
    for f in ("rank_service_embedding.json", "signature.json"):
        with open(os.path.join(dj, f)) as a, open(os.path.join(dt, f)) as b:
            assert a.read() == b.read(), f
    # a TFPlus export leaves the tables (their delta bits too) as they were
    for j, t in zip(jt, tt):
        assert_same_table(j, t)
    for mod, tabs, md in ((jserving, jt, jmd), (tserving, tt, tmd)):
        with pytest.raises(ValueError, match="local directory"):
            mod.export_for_serving("oss://bkt/x", {"item_emb": tabs}, md,
                                   format="tfplus")


def test_crc32c_helper_and_plain_version():
    assert crc32c.value(b"123456789") == 0xE3069283
    assert crc32c.extend_py(0, b"123456789") == 0xE3069283
    assert crc32c.extend_table_loop(0, b"123456789") == 0xE3069283
    assert crc32c.value(b"") == 0 and crc32c.mask(0) == 0xA282EAD8
    rng = np.random.RandomState(0)
    # short, unaligned, and past three 8 KiB stripes (the three-stream path)
    for n in (1, 7, 8, 9, 63, 4096, 3 * 8192 + 13, 100_003):
        buf = rng.randint(0, 256, n + 3).astype(np.uint8)
        data = buf[3:]                               # unaligned start
        want = crc32c.extend_py(0, data.tobytes())
        assert crc32c.value(data) == want, n
        assert crc32c.extend_table_loop(0, data) == want, n
        cut = n // 3
        assert crc32c.extend(crc32c.value(data[:cut]), data[cut:]) == want


def test_corruption_and_bad_prefixes_raise(ckpt, tmp_path):
    src = os.path.dirname(ckpt["plain"])
    bad = str(tmp_path / "bad")
    shutil.copytree(src, bad)
    prefix = os.path.join(bad, "model.ckpt-100")
    r = tf_bundle.TFBundleReader(prefix)
    e = r.entry("wide/part_1-values")
    with open(prefix + DATA, "r+b") as f:
        f.seek(e.offset + 5)
        b = f.read(1)
        f.seek(e.offset + 5)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(IOError, match="wide/part_1-values.*checksum"):
        r.get_tensor("wide/part_1-values")
    with pytest.raises(IOError, match=re.escape(prefix)):
        timport.import_kv_variable(prefix, "wide", device="cpu")
    r.get_tensor("wide/part_0-values")              # the others still read
    s = r.entry("dense/strings")
    with open(prefix + DATA, "r+b") as f:
        f.seek(s.offset + s.size - 1)
        f.write(b"?")
    with pytest.raises(IOError, match="dense/strings"):
        r.get_tensor("dense/strings")
    # an index byte: the block's CRC32C catches it
    with open(prefix + ".index", "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(IOError, match="checksum"):
        tf_bundle.TFBundleReader(prefix)
    # a compressed block (type 1, its CRC made right) is refused
    with open(ckpt["plain"] + ".index", "rb") as f:
        idx = bytearray(f.read())
    (moff, _), i = tf_bundle._handle(idx[-48:])
    (ioff, isz), _ = tf_bundle._handle(idx[-48:], i)
    block = bytes(idx[ioff:ioff + isz])
    (doff, dsz), _ = tf_bundle._handle(
        next(tf_bundle._block_entries(block))[1])
    idx[doff + dsz] = 1
    idx[doff + dsz + 1:doff + dsz + 5] = tf_bundle._block_crc(
        bytes(idx[doff:doff + dsz]), 1).to_bytes(4, "little")
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(idx))
    with pytest.raises(ValueError, match="compression type 1"):
        tf_bundle.TFBundleReader(prefix)
    for fn in (lambda: tf_bundle.TFBundleReader("oss://bkt/ck"),
               lambda: tf_bundle.write_bundle("s3://bkt/ck", ["x"], [[1]]),
               lambda: texport.export_checkpoint("dfs://u@h/x/ck", {})):
        with pytest.raises(ValueError, match="local path"):
            fn()
    with pytest.raises(FileNotFoundError):
        tf_bundle.TFBundleReader(str(tmp_path / "none" / "ck"))
    with pytest.raises(ValueError, match="duplicate"):
        tf_bundle.write_bundle(str(tmp_path / "dup"), ["a", "a"], [[1], [2]])
    assert not os.path.exists(str(tmp_path / "dup") + ".index")
