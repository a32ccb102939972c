"""Port parity for the data feed and its readers.

Bit for bit against the JAX package: ``make_packed_feed``'s buffers, its
round trips and its ``ValueError`` guards; the native helper library
against its pure-Python twins (FarmHash, FNV-1a, CRC32, the Criteo parser)
and against the JAX package's; the Criteo readers (the file's order with
one thread, the same multiset of rows with several) and the binary cache,
which each package reads when the other wrote it; the synthetic generators
and the MovieLens reader. The packed feed drives the port's DCN step to
the same losses and tables, bit for bit, as the per-leaf feed. One small
generated Criteo file serves the module; nothing is downloaded."""
import filecmp
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu.data import criteo as jcriteo
from tfplus_tpu.data import feed as jfeed
from tfplus_tpu.data import movielens as jmovielens
from tfplus_tpu.data import synthetic as jsynthetic
from tfplus_tpu.io import native as jnative
from tfplus_tpu_torch import models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu_torch.data import criteo, feed, movielens, synthetic
from tfplus_tpu_torch.io import native

ROWS = 700


def write_criteo_tsv(path, rows, seed):
    """Criteo Kaggle layout: a label, 13 integer columns (some negative,
    some empty) and 26 categorical columns of 8 hex digits (some empty),
    plus one malformed line; the last line has no newline."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        ints = [("" if rng.rand() < 0.15 else str(rng.randint(-3, 5000)))
                for _ in range(13)]
        cats = [("" if rng.rand() < 0.1 else "%08x" % rng.randint(0, 2**32))
                for _ in range(26)]
        lines.append("\t".join([str(rng.randint(0, 2))] + ints + cats))
        if i == 37:
            lines.append("1\t2\t3")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return str(write_criteo_tsv(tmp_path_factory.mktemp("criteo") /
                                "train.txt", ROWS, seed=5))


def _jax_python_batches(monkeypatch, path, bs):
    """The JAX package's pure-Python reader (its library switched off)."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    return list(jcriteo.batches(path, bs))


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("numeric", "categorical", "label"):
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          k)
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


def test_native_library_builds_beside_the_port():
    assert native.available()
    so = native._build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert "_build" in so.parts and "native" in so.parts


@pytest.mark.parametrize("algo", ["farmhash", "fnv"])
def test_hashes_match_the_twins_and_jax(algo):
    rng = np.random.RandomState(1)
    strings = [bytes(rng.randint(0, 256, n, dtype=np.uint8))
               for n in list(range(0, 80)) + [100, 127, 128, 129, 200, 1000]]
    want = [jnative.fingerprint64(s, algo) for s in strings]
    assert [native.fingerprint64(s, algo) for s in strings] == want
    assert [native.fingerprint64_py(s, algo) for s in strings] == want
    np.testing.assert_array_equal(native.fingerprint64_batch(strings, algo),
                                  np.asarray(want, np.uint64))
    np.testing.assert_array_equal(
        native.fingerprint64_batch(["a", 12, "feature"], algo),
        jnative.fingerprint64_batch(["a", 12, "feature"], algo))
    if algo == "farmhash":
        assert [jnative._farmhash64_py(s) for s in strings] == want
    for s in strings[:20]:
        assert criteo._fnv1a64(s) == jcriteo._fnv1a64(s)
    for s, seed in zip(strings, range(len(strings))):
        assert native.crc32(s, seed) == native.crc32_py(s, seed) \
            == zlib.crc32(s, seed) == jnative.crc32(s, seed)


def test_parsers_agree_bit_for_bit(tsv):
    buf = open(tsv, "rb").read()
    for max_rows in (1, 64, ROWS + 5):
        lib = native.parse_criteo_batch(buf, max_rows)
        py = native.parse_criteo_batch_py(buf, max_rows)
        ref = jnative.parse_criteo_batch(buf, max_rows)
        for a, b, c in zip(lib, py, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    numeric, cats, labels, consumed = lib
    assert len(labels) == ROWS - 1      # the last line has no newline
    assert consumed == buf.rindex(b"\n") + 1
    assert numeric.dtype == np.float32 and cats.dtype == np.int64
    assert (cats >> 40 == np.arange(26)).all()


def test_readers_match_jax(tsv, monkeypatch):
    ours = list(criteo.batches(tsv, 64))
    assert len(ours) == ROWS // 64
    _same_batches(ours, list(jcriteo.batches(tsv, 64)))
    _same_batches(list(criteo.batches(tsv, 64, threads=1)), ours)
    _same_batches(list(criteo.batches(tsv, 64, max_batches=3)), ours[:3])
    _same_batches(list(criteo.python_batches(tsv, 64)), ours)
    # eight parser threads: rows of the file, in some order (which full
    # batches come first, and so which rows the short tail drops, varies)
    many = list(criteo.batches(tsv, 64, threads=8))
    assert len(many) == len(ours)
    every = native.parse_criteo_batch(open(tsv, "rb").read() + b"\n",
                                      ROWS)[:3]
    every = {"numeric": every[0], "categorical": every[1], "label": every[2]}
    assert set(_rows([every])) >= set(_rows(many))
    _same_batches(_jax_python_batches(monkeypatch, tsv, 64), ours)


def _rows(batches):
    """Every row of ``batches`` as a tuple of its bits, sorted."""
    return sorted(tuple(np.concatenate([b["numeric"][i].view(np.int32),
                                        b["categorical"][i].view(np.int32),
                                        b["label"][i:i + 1].view(np.int32)]))
                  for b in batches for i in range(len(b["label"])))


def test_loader_returns_every_row_once(tsv):
    """One thread: every row in the file's order (the unterminated last
    line included); eight: the same multiset of rows."""
    lib = native.parse_criteo_batch(open(tsv, "rb").read() + b"\n", ROWS)
    every = [{"numeric": lib[0], "categorical": lib[1], "label": lib[2]}]
    for threads in (1, 8):
        with native.CriteoLoader(tsv, 100, threads=threads) as ld:
            got = [{"numeric": n, "categorical": c, "label": la}
                   for n, c, la in ld]
        assert sum(len(b["label"]) for b in got) == ROWS
        if threads == 1:
            np.testing.assert_array_equal(
                np.concatenate([b["categorical"] for b in got]), lib[1])
        assert _rows(got) == _rows(every)
    with pytest.raises(FileNotFoundError):
        native.CriteoLoader(tsv + ".missing", 10)


def test_binary_cache_crosses_packages(tsv, tmp_path):
    ours = criteo.build_binary_cache(tsv, str(tmp_path / "ours"),
                                     block_rows=100)
    theirs = jcriteo.build_binary_cache(tsv, str(tmp_path / "theirs"),
                                        block_rows=100)
    for name in ("numeric.npy", "categorical.npy", "label.npy", "meta.json"):
        assert filecmp.cmp(os.path.join(ours, name),
                           os.path.join(theirs, name), shallow=False), name
    for a, b in ((ours, theirs), (theirs, ours)):
        mine, other = criteo.BinaryCriteoCache(a), jcriteo.BinaryCriteoCache(b)
        assert mine.rows == other.rows == ROWS
        _same_batches(list(mine.batches(64)), list(other.batches(64)))
    cache = criteo.BinaryCriteoCache(ours)
    looped = list(cache.batches(300, max_batches=5, loop=True))
    assert len(looped) == 5
    np.testing.assert_array_equal(looped[2]["label"], looped[0]["label"])
    # the cache holds what the readers give, row for row, in order
    flat = np.concatenate([b["categorical"] for b in criteo.batches(tsv, 1)])
    np.testing.assert_array_equal(cache.categorical[:len(flat)], flat)
    # an existing cache is reused
    mtime = os.path.getmtime(os.path.join(ours, "numeric.npy"))
    criteo.build_binary_cache(tsv, ours)
    assert os.path.getmtime(os.path.join(ours, "numeric.npy")) == mtime


def _example(rng, b=6):
    return {"ids": {"C2": rng.randint(-9, 9, (b, 2)).astype(np.int32),
                    "C1": rng.randint(-9, 9, (b, 2)).astype(np.int32)},
            "features": rng.randn(b, 3).astype(np.float32),
            "labels": rng.rand(b).astype(np.float32),
            "meta": np.array([0, 1, 2**31, 2**32 - 1, 7, 9][:b], np.uint32),
            "pair": (rng.randn(2).astype(np.float32), None)}


def test_packed_feed_matches_jax():
    rng = np.random.RandomState(0)
    ex = _example(rng)
    jpack, junpack = jfeed.make_packed_feed(ex)
    pack, unpack = feed.make_packed_feed(ex, device="cpu")
    for _ in range(3):
        b = _example(rng)
        flat = pack(b)
        assert flat.dtype == torch.int32 and not flat.is_pinned()
        np.testing.assert_array_equal(flat.numpy(), jpack(b))
        got, want = unpack(flat), junpack(jnp.asarray(jpack(b)))
        for k in ("features", "labels"):
            assert got[k].data_ptr() >= flat.data_ptr()    # a view
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for k in ("C1", "C2"):
            np.testing.assert_array_equal(got["ids"][k].numpy(), b["ids"][k])
        # uint32 comes back as int32 holding the same bits
        assert got["meta"].dtype == torch.int32
        np.testing.assert_array_equal(got["meta"].numpy().view(np.uint32),
                                      np.asarray(want["meta"]))
        np.testing.assert_array_equal(got["pair"][0].numpy(), b["pair"][0])
        assert got["pair"][1] is None and isinstance(got["pair"], tuple)


def test_packed_feed_guards():
    rng = np.random.RandomState(1)
    ex = _example(rng)
    pack, unpack = feed.make_packed_feed(ex, device="cpu")
    bad = _example(rng)
    bad["labels"] = bad["labels"][:5]
    with pytest.raises(ValueError):
        pack(bad)
    bad = _example(rng)
    bad["features"] = bad["features"].astype(np.int32)
    with pytest.raises(ValueError):
        pack(bad)
    bad = _example(rng)
    del bad["ids"]["C2"]
    with pytest.raises(ValueError):
        pack(bad)
    flat = pack(_example(rng))
    with pytest.raises(ValueError):
        unpack(flat[:-1])
    with pytest.raises(ValueError):
        unpack(flat.float())
    for leaf in (np.zeros(3, np.int64), np.zeros(3, np.float64),
                 np.zeros(3, np.int16)):
        with pytest.raises(ValueError):
            feed.make_packed_feed({"x": leaf}, device="cpu")
        with pytest.raises(ValueError):
            jfeed.make_packed_feed({"x": leaf})


def _dcn_feed_batch(batch, names):
    """A cache batch as the DCN step's batch: each categorical column as
    ``int32[B, 2]`` encoded ids (little-endian words), contiguous."""
    pairs = np.ascontiguousarray(batch["categorical"]).view(np.int32)
    pairs = pairs.reshape(len(batch["label"]), len(names), 2)
    return {"ids": {n: np.ascontiguousarray(pairs[:, j])
                    for j, n in enumerate(names)},
            "features": np.array(batch["numeric"]),
            "labels": np.array(batch["label"])}


def test_packed_feed_drives_dcn_like_the_per_leaf_feed(tsv, tmp_path):
    """The same cache batches through the per-leaf feed and the packed one
    give the same losses and tables, bit for bit; the ids equal those
    ``kv.encode_ids`` makes of the cache's int64 column."""
    from tfplus_tpu_torch.kv import hashing
    cache = criteo.BinaryCriteoCache(
        criteo.build_binary_cache(tsv, str(tmp_path / "cache")))
    model = tmodels.DCN(uniform_dim=4, dnn_hidden=(8, 4), capacity=1 << 10)
    names = [f"C{i + 1}" for i in range(26)]
    opt = ttrain.GroupAdamOptimizer()
    batches = [_dcn_feed_batch(b, names) for b in cache.batches(128)]
    np.testing.assert_array_equal(
        batches[0]["ids"]["C7"],
        hashing.encode_ids(np.asarray(cache.categorical[:128, 6]),
                           device="cpu").numpy())
    pack, unpack = feed.make_packed_feed(batches[0], device="cpu")
    runs = []
    for packed in (False, True):
        state = tmodels.init_state(
            model, opt, lambda p: torch.optim.Adam(p, lr=1e-3), seed=3,
            device="cpu")
        step = tmodels.make_train_step(model, opt, sparse_lr=1e-3)
        losses = []
        for b in batches:
            state, loss, _ = step(state, unpack(pack(b)) if packed else b)
            losses.append(loss.item())
        runs.append((losses, {n: (t.header.clone(), t.payload.clone())
                              for n, t in state.tables.items()}))
    assert runs[0][0] == runs[1][0]
    for n in names:
        for a, b in zip(runs[0][1][n], runs[1][1][n]):
            assert torch.equal(a, b), n


def test_synthetic_generators_match_jax():
    for k in ("user_id", "movie_id", "rating"):
        np.testing.assert_array_equal(
            synthetic.movielens_like(500, seed=3)[k],
            jsynthetic.movielens_like(500, seed=3)[k])
    for a, b in zip(synthetic.dlrm_batches(64, 2, num_tables=3, vocab=99),
                    jsynthetic.dlrm_batches(64, 2, num_tables=3, vocab=99)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    ours = synthetic.BehaviorSequence(n_items=50, n_users=9, seq_len=6, seed=2)
    theirs = jsynthetic.BehaviorSequence(n_items=50, n_users=9, seq_len=6,
                                         seed=2)
    for a, b in zip(ours.batches(32, 2), theirs.batches(32, 2)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_movielens_reads_a_generated_file(tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    path = tmp_path / "u.data"
    rows = np.stack([rng.randint(1, 944, 300), rng.randint(1, 1683, 300),
                     rng.randint(1, 6, 300), rng.randint(8e8, 9e8, 300)], 1)
    np.savetxt(path, rows, fmt="%d", delimiter="\t")
    monkeypatch.setenv("MOVIELENS_PATH", str(path))
    assert movielens.available() == jmovielens.available() == str(path)
    assert movielens.available(str(path)) == str(path)
    for a, b in ((movielens.load(str(path)), jmovielens.load(str(path))),
                 (movielens.load_or_synthetic(seed=5),
                  jmovielens.load_or_synthetic(seed=5))):
        for k in ("user_id", "movie_id", "rating"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    monkeypatch.setenv("MOVIELENS_PATH", str(tmp_path / "missing"))
    if movielens.available() is None:
        got = movielens.load_or_synthetic(200, seed=1)
        np.testing.assert_array_equal(
            got["rating"], jsynthetic.movielens_like(200, seed=1)["rating"])
