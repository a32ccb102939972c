"""Port parity for checkpoints: bundles, save/restore (full and delta, with
slot columns and dense state), first_n modes, the manager's lineage rules,
elastic repartition, multihost saves and bounded streaming.

A checkpoint written by either package restores in the other to tables
bit-identical (header, payload, deletion log) to the other package's own
restore of the same bundle, and the two packages write the same tensors.
The last test is the port's twin of examples/checkpoint_resume.py at its
own sizes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import checkpoint as jckpt
from tfplus_tpu import kv as jkv
from tfplus_tpu import models as jmodels
from tfplus_tpu import train as jtrain
from tfplus_tpu.checkpoint import bundle as jbundle
from tfplus_tpu.checkpoint import saver as jsaver
from tfplus_tpu_torch import checkpoint as tckpt
from tfplus_tpu_torch import convert, kv as tkv
from tfplus_tpu_torch import models as tmodels
from tfplus_tpu_torch import train as ttrain
from tfplus_tpu_torch.checkpoint import bundle as tbundle
from tfplus_tpu_torch.checkpoint import repartition as trep
from tfplus_tpu_torch.checkpoint import saver as tsaver
from tfplus_tpu_torch.io import filesystem as tfs
from tfplus_tpu_torch.utils import progress as tprogress
from test_torch_growth import _filled
from test_torch_table import assert_same_table, jax_init_dense, to_port


def _tenc(ids):
    return tkv.encode_ids_np_to_device(np.asarray(ids, np.int64), "cpu")


def _jenc(ids):
    return jkv.encode_ids_np_to_device(np.asarray(ids, np.int64))


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

TENSORS = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
           "u64": np.array([1, 2**63 + 5, 2**64 - 3], np.uint64),
           "i8": np.array([1, -2], np.int8),
           "u16": np.array([7, 65535], np.uint16),
           "scalar": np.array(3.5, np.float64),
           "big_endian": np.arange(5, dtype=">i4")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bundles_read_in_the_other_package(tmp_path, writer):
    wmod, rmod = ((jbundle, tbundle) if writer == "jax"
                  else (tbundle, jbundle))
    p = str(tmp_path / "b")
    with wmod.BundleWriter(p, num_shards=2) as w:
        for k, v in TENSORS.items():
            w.add(k, v)
        w.add_header("streamed", np.float32, (5, 2))
        for a in range(0, 5, 2):
            w.append_segment(np.arange(a * 2, min(a + 2, 5) * 2,
                                       dtype=np.float32).reshape(-1, 2))
        w.end_segment()
        w.add_alias("alias", "u64")
    for reader in (rmod.BundleReader(p), wmod.BundleReader(p)):
        for k, v in TENSORS.items():
            got = reader.lookup(k)
            np.testing.assert_array_equal(got, v)
            assert got.dtype == v.dtype.newbyteorder("=")
        np.testing.assert_array_equal(
            reader.lookup("streamed"), np.arange(10, dtype=np.float32)
            .reshape(5, 2))
        np.testing.assert_array_equal(reader.lookup("alias"), TENSORS["u64"])
        np.testing.assert_array_equal(reader.lookup_slice("streamed", 1, 2),
                                      [[2, 3], [4, 5]])
        assert [s for s, _ in reader.stream("streamed", 2)] == [0, 2, 4]
    # the CRC catches one flipped byte, in both readers
    entry = rmod.BundleReader(p)._index["f32"]
    path = rmod.data_filename(p, entry["shard"], 2)
    raw = bytearray(open(path, "rb").read())
    raw[entry["offset"] + 5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for mod in (jbundle, tbundle):
        with pytest.raises(IOError, match="CRC"):
            mod.BundleReader(p).lookup("f32")
        with pytest.raises(IOError, match="CRC"):
            list(mod.BundleReader(p).stream("f32", 1))


def test_filesystem_and_progress_copies(monkeypatch):
    """The port's copies of io/filesystem.py and utils/progress.py behave as
    the JAX package's originals."""
    from tfplus_tpu.io import filesystem as jfs
    from tfplus_tpu.utils import progress as jprogress
    import io
    for uri in ("oss://bkt\x01id=a\x02key=b\x02host=h/x/y",
                "oss://bkt?id=a&key=b/x", "oss://plain/obj", "bkt/o"):
        assert tfs.parse_oss_uri(uri) == jfs.parse_oss_uri(uri)
    mems = (tfs.MemFileSystem(), jfs.MemFileSystem())
    for fs in mems:
        fs.makedirs("d")
        with fs.open("d/a.bin", "wb") as f:
            f.write(b"xy")
        with fs.open("d/a.bin", "ab") as f:
            f.write(b"z")
        fs.rename("d/a.bin", "d/b.bin")
    for call in (lambda fs: fs.listdir("d"), lambda fs: fs.listdir(""),
                 lambda fs: fs.exists("d"), lambda fs: fs.size("d/b.bin"),
                 lambda fs: fs.open("d/b.bin").read()):
        assert call(mems[0]) == call(mems[1])
    assert tfs.get_filesystem("ram://k/a.bin")[1] == "k/a.bin"
    assert tfs.get_filesystem("file:///tmp/x")[1] == \
        jfs.get_filesystem("file:///tmp/x")[1]
    with pytest.raises(ValueError, match="tfplus_tpu_torch"):
        tfs.get_filesystem("nope://a")
    assert tprogress.MIN_ROWS_FOR_BAR == jprogress.MIN_ROWS_FOR_BAR
    drawn = []
    for mod in (tprogress, jprogress):
        clock = iter(float(t) for t in range(100))
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
        out = io.StringIO()
        bar = mod.ProgressBar("restore t", 3, stream=out, enabled=True,
                              min_interval_s=0.0)
        for _ in range(3):
            bar.update(1)
        bar.done()
        drawn.append(out.getvalue())
    assert drawn[0] == drawn[1] and "100.0%" in drawn[0]


def test_packing_reference_words_match_jax():
    """The on-disk freq|day16 word and the unix-day reconstruction from the
    13-bit ring, bit for bit, with ``as_of_unix_day`` pinned."""
    from tfplus_tpu.utils import packing as jp
    from tfplus_tpu_torch.utils import packing as tp
    rng = np.random.RandomState(11)
    meta = rng.randint(0, 2**32, 500, dtype=np.int64).astype(np.uint32)
    assert tp.DAY_BITS == jp.DAY_BITS
    for day in (20000, 20000 + 8191, 123):
        np.testing.assert_array_equal(tp.reference_day_np(meta, day),
                                      jp.reference_day_np(meta, day))
        np.testing.assert_array_equal(tp.reference_word_np(meta, day),
                                      jp.reference_word_np(meta, day))
    t = torch.from_numpy(meta.astype(np.int64))
    j = jnp.asarray(meta)
    np.testing.assert_array_equal(tp.to_reference_word(t).numpy(),
                                  np.asarray(jp.to_reference_word(j)))
    words = np.asarray(jp.to_reference_word(j))
    np.testing.assert_array_equal(
        tp.from_reference_word(torch.from_numpy(words.astype(np.int64)),
                               tp.FLAG_TOUCH_BOTH).numpy(),
        np.asarray(jp.from_reference_word(jnp.asarray(words),
                                          jp.FLAG_TOUCH_BOTH)))
    rows = rng.randint(0, 8192, 500)
    for now in (5, 8191, 20003):
        np.testing.assert_array_equal(
            tp.day_age(now, torch.from_numpy(rows)).numpy(),
            np.asarray(jp.day_age(now, jnp.asarray(rows, jnp.uint32))))


# ---------------------------------------------------------------------------
# save / restore across packages
# ---------------------------------------------------------------------------

def _dcn_dense():
    """The small DCN's dense state in both packages, equal values."""
    kw = dict(embedding_dims=(8, 8), num_numeric=3, dnn_hidden=(8, 4),
              capacity=32)
    jdense = jax_init_dense(jmodels.DCN(**kw), 3)
    jdense = jax.tree_util.tree_map(np.asarray, jax.device_get(jdense))
    tmodel = tmodels.DCN(**kw)
    tdense = tmodel.init_dense(torch.Generator().manual_seed(0), "cpu")
    convert.dense_from_numpy(tdense, jdense)
    return jdense, tdense, tmodel


def _assert_dense_equal(jdense, tdense):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jdense)[0]:
        flat[".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)] = np.asarray(leaf)
    state = tdense.state_dict()
    assert sorted(flat) == sorted(state)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v, k)


def _mutate(rng, jt, tt, n_new, n_del, ids):
    """The same inserts (new ids) and deletes on both tables."""
    more = rng.randint(1 << 41, 1 << 42, n_new).astype(np.int64)
    gone = ids[:n_del]
    jt = jkv.lookup_or_insert(jt, _jenc(more), day=11).table
    tt = tkv.lookup_or_insert(tt, _tenc(more), day=11).table
    jt, _ = jkv.delete(jt, _jenc(gone))
    tt, _ = tkv.delete(tt, _tenc(gone))
    return jt, tt


def _bundle_tensors(p, mod):
    r = mod.BundleReader(p)
    return {k: np.asarray(r.lookup(k)) for k in r.keys()}


def test_save_restore_across_packages(tmp_path):
    """Full then delta saves of a slotted table and two shards, with the
    DCN's dense state, from each package. The two packages write the same
    tensors, so the JAX package's restore of its own lineage stands for its
    restore of the port's; the port restores both lineages to tables
    bit-identical to it and to equal dense weights."""
    rng = np.random.RandomState(7)
    jt, tt, ids = _filled(rng, 128, slots=True)
    js = [_filled(rng, 64, capacity=128)[0] for _ in range(2)]
    ts = [to_port(s) for s in js]
    jdense, tdense, tmodel = _dcn_dense()
    roots = {w: str(tmp_path / w) for w in ("jax", "port")}

    jt = jsaver.save(roots["jax"] + "/full", {"emb": jt, "sh": js},
                     jdense)["emb"]
    tt = tsaver.save(roots["port"] + "/full", {"emb": tt, "sh": ts},
                     tdense)["emb"]
    assert_same_table(jt, tt)             # the full save reset the baseline
    jt, tt = _mutate(rng, jt, tt, 16, 16, ids)
    jt = jsaver.save(roots["jax"] + "/delta", {"emb": jt}, delta=True,
                     first_n=jsaver.FIRST_N_DELTA)["emb"]
    tt = tsaver.save(roots["port"] + "/delta", {"emb": tt}, delta=True,
                     first_n=tsaver.FIRST_N_DELTA)["emb"]
    assert_same_table(jt, tt)             # the delta save cleared alike
    for kind in ("full", "delta"):
        a = _bundle_tensors(f"{roots['jax']}/{kind}", jbundle)
        b = _bundle_tensors(f"{roots['port']}/{kind}", tbundle)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)

    jtmpl = {"emb": jkv.ensure_slots(jkv.create(8, 64, seed=9),
                                     {"m": 1, "v": 2}),
             "sh": [jkv.create(8, 64, seed=9) for _ in range(2)]}
    jout, jd = jsaver.restore(roots["jax"] + "/full", jtmpl,
                              jax.tree_util.tree_map(np.zeros_like, jdense))
    jout["emb"] = jsaver.restore(roots["jax"] + "/delta",
                                 {"emb": jout["emb"]}, delta=True)[0]["emb"]
    for a, b in zip(jax.tree_util.tree_leaves(jdense),
                    jax.tree_util.tree_leaves(jd)):
        np.testing.assert_array_equal(np.asarray(b), a)
    for writer, root in roots.items():
        ttmpl = {"emb": to_port(jtmpl["emb"]),
                 "sh": [to_port(s) for s in jtmpl["sh"]]}
        fresh = tmodel.init_dense(torch.Generator().manual_seed(5), "cpu")
        tout, td = tsaver.restore(root + "/full", ttmpl, fresh)
        assert td is fresh
        tout["emb"] = tsaver.restore(root + "/delta", {"emb": tout["emb"]},
                                     delta=True)[0]["emb"]
        assert tout["emb"].capacity == 256, writer       # grew from 64
        assert_same_table(jout["emb"], tout["emb"])
        for a, b in zip(jout["sh"], tout["sh"]):
            assert_same_table(a, b)
        _assert_dense_equal(jdense, td)


@pytest.mark.parametrize("first_n", [2, 3, 4, 6, 8])
def test_first_n_modes(tmp_path, first_n):
    rng = np.random.RandomState(first_n)
    jt, tt, ids = _filled(rng, 64, slots=True)
    jsaver.save(str(tmp_path / "j"), {"t": jt}, first_n=first_n)
    tsaver.save(str(tmp_path / "t"), {"t": tt}, first_n=first_n)
    a = _bundle_tensors(str(tmp_path / "j"), jbundle)
    b = _bundle_tensors(str(tmp_path / "t"), tbundle)
    assert sorted(a) == sorted(b)
    assert ("t-slot-m" in b) == (first_n >= 6)
    assert ("t-init_table" in b) == (first_n >= 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    out, _ = tsaver.restore(str(tmp_path / "j"),
                            {"t": tkv.create(8, 64, device="cpu")})
    np.testing.assert_array_equal(
        tkv.lookup_or_zeros(out["t"], _tenc(ids)).numpy(),
        tkv.lookup_or_zeros(tt, _tenc(ids)).numpy())


# ---------------------------------------------------------------------------
# the manager's lineage rules
# ---------------------------------------------------------------------------

def _small(rng, n=20):
    t = tkv.create(4, 256, seed=0, device="cpu")
    ids = rng.randint(1, 1 << 30, n).astype(np.int64)
    return tkv.insert(t, _tenc(ids), torch.ones(n, 4)), ids


def test_manager_lineage_rules(tmp_path):
    rng = np.random.RandomState(0)
    t, ids = _small(rng)
    mgr = tckpt.CheckpointManager(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="before any full"):
        mgr.save({"t": t}, step=1, full=False)
    t = mgr.save({"t": t}, {"w": torch.ones(3)}, step=1, full=True)["t"]
    tkv.lookup_or_insert(t, _tenc(ids[:5]))
    t = mgr.save({"t": t}, {"w": torch.full((3,), 2.0)}, step=2,
                 full=False)["t"]
    assert [d["step"] for d in mgr.latest()["deltas"]] == [2]
    # the JAX package reads the port's lineage, dense from the last delta
    jout, jd, step = jckpt.CheckpointManager(str(tmp_path / "a")).restore(
        {"t": jkv.create(4, 256)}, {"w": np.zeros(3, np.float32)})
    assert step == 2
    np.testing.assert_array_equal(np.asarray(jd["w"]), 2.0)
    tout, td, _ = tckpt.CheckpointManager(str(tmp_path / "a")).restore(
        {"t": to_port(jkv.create(4, 256))}, {"w": torch.zeros(3)})
    assert_same_table(jout["t"], tout["t"])
    assert torch.equal(td["w"], torch.full((3,), 2.0))

    # an overflowed deletion log: the delta is refused on restore, and the
    # manager escalates such a snapshot to a full one
    t.deleted_overflow = torch.tensor(True)
    p = str(tmp_path / "overflowed")
    tsaver.save(p, {"t": t}, delta=True, first_n=tsaver.FIRST_N_DELTA)
    with pytest.raises(ValueError, match="need_full_import"):
        tsaver.restore(p, {"t": tkv.create(4, 256, device="cpu")},
                       delta=True)
    with pytest.raises(ValueError, match="need_full_import"):
        jsaver.restore(p, {"t": jkv.create(4, 256)}, delta=True)
    t.deleted_overflow = torch.tensor(True)
    t = mgr.save({"t": t}, step=3, full=False)["t"]
    assert mgr.latest()["full"]["step"] == 3 and mgr.latest()["deltas"] == []
    assert not bool(t.deleted_overflow)


def test_manager_failed_background_save_escalates(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    t, ids = _small(rng)
    mgr = tckpt.CheckpointManager(str(tmp_path / "b"), max_to_keep=2)
    t = mgr.save({"t": t}, step=1, full=True, background=True)["t"]
    mgr.wait()
    assert mgr.latest()["full"]["step"] == 1

    class _Failing:
        def result(self):
            raise IOError("disk full (injected)")

    monkeypatch.setattr(tsaver, "save_async",
                        lambda *a, **k: (a[1], _Failing()))
    t = mgr.save({"t": t}, step=2, full=False, background=True)["t"]
    with pytest.raises(IOError, match="injected"):
        mgr.wait()
    monkeypatch.undo()
    t = mgr.save({"t": t}, step=3, full=False)["t"]          # escalated
    assert mgr.latest()["full"]["step"] == 3
    for step in (4, 5, 6):
        t = mgr.save({"t": t}, step=step, full=True)["t"]
    names = os.listdir(tmp_path / "b")
    assert not any(n.startswith("ckpt-full-1.") for n in names)   # GC
    out, _, step = mgr.restore({"t": tkv.create(4, 256, device="cpu")})
    assert step == 6 and int(tkv.size(out["t"])) == 20


# ---------------------------------------------------------------------------
# repartition, multihost, streaming budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(2, 3), (4, 6), (3, 1)])
def test_repartition_matches_jax(tmp_path, m, n):
    # 16 ids in each class mod lcm(m, n): every (source, target) pair moves
    # the same number of rows, so the JAX side compiles each shape once
    rng = np.random.RandomState(10 * m + n)
    lcm = m * n // np.gcd(m, n)
    base = np.unique(rng.randint(1, 1 << 30, 20))[:16]
    all_ids = (base[:, None] * lcm
               + np.arange(lcm)[None, :]).reshape(-1).astype(np.int64)
    opt = jtrain.AdagradOptimizer()
    shards = []
    for g in range(m):
        t = opt.init(jkv.create(8, 256, seed=g))
        mine = all_ids[all_ids % m == g]
        res = jkv.lookup_or_insert(t, _jenc(mine))
        shards.append(opt.apply(res.table, res.slot,
                                jnp.full((len(mine), 8), 0.1), lr=0.1,
                                step=1))
    p = str(tmp_path / "r")
    jsaver.save(p, {"emb": shards})
    assert trep.plan(m, n) == ("MERGE" if n == 1 else "REPARTITION")
    jtmpl = [opt.init(jkv.create(8, 128, seed=20 + i)) for i in range(n)]
    jout, _ = jsaver.restore(p, {"emb": jtmpl})
    tout, _ = tsaver.restore(p, {"emb": [to_port(x) for x in jtmpl]})
    assert sum(int(tkv.size(s)) for s in tout["emb"]) == len(all_ids)
    for a, b in zip(jout["emb"], tout["emb"]):
        assert_same_table(a, b)


def test_multihost_save_of_two_processes(tmp_path):
    rng = np.random.RandomState(3)
    all_ids = np.arange(1, 193, dtype=np.int64)      # 16 per class mod 12
    shard4 = []
    for g in range(4):
        t = tkv.create(8, 512, seed=g, device="cpu")
        mine = all_ids[all_ids % 4 == g]
        shard4.append(tkv.insert(t, _tenc(mine), torch.from_numpy(
            rng.randn(len(mine), 8).astype(np.float32))))
    p = str(tmp_path / "mh")
    for proc in range(2):                 # 2 processes x 2 local shards
        tsaver.save_multihost(p, {"emb": shard4[proc * 2:proc * 2 + 2]},
                              {"w": torch.ones(3)} if proc == 0 else None,
                              process_id=proc, num_processes=2)
    tout, td = tsaver.restore_multihost(
        p, {"emb": [tkv.create(8, 512, seed=9, device="cpu")] * 3},
        {"w": torch.zeros(3)})
    jout, _ = jsaver.restore_multihost(
        p, {"emb": [jkv.create(8, 512, seed=9)] * 3})
    assert torch.equal(td["w"], torch.ones(3))
    assert sum(int(tkv.size(s)) for s in tout["emb"]) == 192
    for a, b in zip(jout["emb"], tout["emb"]):
        assert_same_table(a, b)
    with pytest.raises(FileNotFoundError):
        tsaver.UnionReader(str(tmp_path / "none"))


class _MeterWriter(tbundle.BundleWriter):
    """Records the biggest host buffer of a payload tensor; payload tensors
    must stream."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.max_payload_buf = 0
        self._payload = False

    def add(self, name, array, shard=None):
        assert "-values" not in name and "-slot-" not in name, name
        super().add(name, array, shard)

    def add_header(self, name, dtype, shape, shard=None):
        self._payload = "-values" in name or "-slot-" in name
        super().add_header(name, dtype, shape, shard)

    def append_segment(self, a):
        if self._payload:
            self.max_payload_buf = max(self.max_payload_buf, a.nbytes)
        super().append_segment(a)


class _MeterReader(tbundle.BundleReader):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.max_payload_buf = 0

    def lookup(self, name, verify=True):
        assert "-values" not in name and "-slot-" not in name, name
        return super().lookup(name, verify)

    def stream(self, name, chunk_rows, verify=True):
        for start, rows in super().stream(name, chunk_rows, verify):
            if "-values" in name or "-slot-" in name:
                self.max_payload_buf = max(self.max_payload_buf, rows.nbytes)
            yield start, rows


def test_streaming_chunks_are_bounded(tmp_path):
    chunk, dim, n = 64, 16, 900
    opt = ttrain.AdagradOptimizer()
    tabs = []
    for g in range(2):
        t = opt.init(tkv.create(dim, 2048, seed=g, device="cpu"))
        ids = np.arange(1, n + 1, dtype=np.int64) * 2 + g
        res = tkv.lookup_or_insert(t, _tenc(ids))
        tabs.append(opt.apply(res.table, res.slot, torch.full((n, dim), 0.01),
                              lr=0.1, step=1))
    budget = chunk * dim * 4
    p = str(tmp_path / "big")
    w = _MeterWriter(p)
    for g, t in enumerate(tabs):
        tsaver.save_table(w, f"emb/part_{g}", t, chunk_rows=chunk)
    w.add("emb-num_shards", np.array([2], np.int32))
    w.close()
    assert 0 < w.max_payload_buf <= budget
    r = _MeterReader(p)
    t2 = tsaver.restore_table(r, "emb/part_0",
                              tkv.create(dim, 2048, device="cpu"),
                              chunk_rows=chunk)
    assert 0 < r.max_payload_buf <= budget
    q = _tenc(np.arange(1, n + 1, dtype=np.int64) * 2)
    assert torch.equal(tkv.lookup_or_zeros(t2, q),
                       tkv.lookup_or_zeros(tabs[0], q))
    s, wd = t2.config.slot_columns()["accum"]
    assert torch.equal(t2.payload[tkv.find(t2, q).slot.long(), s:s + wd],
                       tabs[0].payload[tkv.find(tabs[0], q).slot.long(),
                                       s:s + wd])
    r = _MeterReader(p)
    shards = trep.restore_repartitioned(
        r, "emb", [tkv.create(dim, 2048, device="cpu") for _ in range(3)], 2,
        chunk_rows=chunk)
    assert 0 < r.max_payload_buf <= budget
    assert sum(int(tkv.size(x)) for x in shards) == 2 * n


# ---------------------------------------------------------------------------
# the twin of examples/checkpoint_resume.py
# ---------------------------------------------------------------------------

def test_checkpoint_resume_twin(tmp_path):
    """Train 4 shards (dim 16, 2^12 rows, GroupAdam lr 0.05) for 30 steps of
    256 ids drawn from 5,000; a full checkpoint at step 20 and deltas at 25
    and 30; "crash"; restore into 6 shards, where a 64-id sample matches
    bit for bit; then 5 more steps."""
    rng = np.random.RandomState(0)
    opt = ttrain.GroupAdamOptimizer(learning_rate=0.05)

    def train_steps(shards, start, n_steps):
        ns = len(shards)
        for s in range(start, start + n_steps):
            ids = rng.randint(0, 5000, 256)
            for i in range(ns):
                sel = np.unique(ids[ids % ns == i])
                res = tkv.lookup_or_insert(shards[i], _tenc(sel))
                shards[i] = opt.apply(res.table, res.slot,
                                      res.rows * 0.1 + 0.01, lr=0.05, step=s,
                                      payload_rows=res.payload_rows,
                                      meta_rows=res.meta_rows)
        return shards

    def lookup_all(shards, ids):
        out = np.zeros((len(ids), 16), np.float32)
        for i in range(len(shards)):
            sel = ids % len(shards) == i
            if sel.any():
                out[sel] = tkv.lookup_or_zeros(shards[i],
                                               _tenc(ids[sel])).numpy()
        return out

    d = str(tmp_path / "ckpts")
    mgr = tckpt.CheckpointManager(d)
    shards = [opt.init(tkv.create(16, 1 << 12, seed=i, name=f"emb/part_{i}",
                                  device="cpu")) for i in range(4)]
    shards = train_steps(shards, 1, 20)
    shards = mgr.save({"emb": shards}, step=20, full=True)["emb"]
    shards = train_steps(shards, 21, 5)
    shards = mgr.save({"emb": shards}, step=25, full=False)["emb"]
    shards = train_steps(shards, 26, 5)
    mgr.save({"emb": shards}, step=30, full=False)
    sample = rng.randint(0, 5000, 64).astype(np.int64)
    want = lookup_all(shards, sample)

    templates = [opt.init(tkv.create(16, 1 << 12, seed=99 + i,
                                     name=f"emb/part_{i}", device="cpu"))
                 for i in range(6)]
    restored, _, step = tckpt.CheckpointManager(d).restore(
        {"emb": templates})
    assert step == 30
    new = restored["emb"]
    np.testing.assert_array_equal(lookup_all(new, sample), want)
    before = sum(int(tkv.size(s)) for s in new)
    new = train_steps(new, step + 1, 5)
    assert sum(int(tkv.size(s)) for s in new) >= before
    assert all(bool(torch.isfinite(s.payload).all()) for s in new)
