"""The probe kernel (``ops/csrc/probe.cu``) on the card, held bit for bit
against the table's plain find (``kv.table._find_plain``, run on the same
card tensors): slot, found, insert slot, meta, pad, and the ``probed`` and
``found`` counts. Cases: an empty table; headers holding the query keys in
their first bucket, their second or either, among free, tombstoned and
full buckets; keys whose second bucket hit the first and was moved (a
two-bucket table); reserved ids in the query, ``valid`` absent, partly off
and all off, and no key at all; the pad plane of an int8 serving table;
key counts from 1 to 2^18 and capacities from 32 rows to 2^23 (BST's item
table); and a DCN-shaped ``lookup_unique`` on the card, training and
serving, against the same lookup on a CPU copy. One ``find`` is one launch
and the only kernel of its ``tfp::probe`` span. Marked ``cuda``: every
test skips without a card. On a machine with a card and without JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_probe_cuda.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from tfplus_tpu_torch import embedding, kv
from tfplus_tpu_torch.kv import hashing, quant
from tfplus_tpu_torch.kv import table as kt
from tfplus_tpu_torch.ops import probe
from tfplus_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

_B = hashing.BUCKET_SIZE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _to(table, device):
    """The table with every tensor copied to ``device``."""
    return dataclasses.replace(table, **{
        f.name: getattr(table, f.name).to(device)
        for f in dataclasses.fields(table)
        if isinstance(getattr(table, f.name), torch.Tensor)})


def _probe_counts() -> tuple:
    c = profiling.counters()
    return c["probed"], c["found"]


def _hold(table, q, valid=None, want_pad=False):
    """``find`` on the card (the kernel) against the plain find on the same
    card tensors: every output and both counts. Returns the counts."""
    profiling.reset_counters()
    want = kt._find_plain(table, q, valid, want_pad=want_pad)
    c_ref = _probe_counts()
    profiling.reset_counters()
    before = probe.probe.launches
    got = kv.find(table, q, valid, want_pad=want_pad)
    torch.cuda.synchronize()
    c_ker = _probe_counts()
    assert probe.probe.launches == before + (1 if q.shape[0] else 0)
    for name, a, b in zip(kt.FindResult._fields, want, got):
        assert _same(a, b), name
    assert c_ref == c_ker
    assert c_ker[1] <= c_ker[0]
    return c_ker


def _keys(rng, n):
    return hashing.encode_ids(
        rng.randint(1, 1 << 62, n, dtype=np.int64), device="cpu")


def _header(rng, groups, q, *, free, tomb, held, side="either"):
    """A header of ``groups`` buckets: each lane EMPTY (share ``free``),
    TOMBSTONE (``tomb``) or another key, with random meta and pad words;
    then a share ``held`` of the keys of ``q`` written into a random lane
    of their first bucket, their second or either (``side``)."""
    c = groups * _B
    lo = rng.randint(-2 ** 31, 2 ** 31, c, dtype=np.int64).astype(np.int32)
    hi = rng.randint(-2 ** 31, 2 ** 31, c, dtype=np.int64).astype(np.int32)
    hi[hi == -1] = 7                      # no other key reads as free
    u = rng.rand(c)
    lo[u < free] = hashing.EMPTY_LO
    lo[(u >= free) & (u < free + tomb)] = hashing.TOMB_LO
    hi[u < free + tomb] = hashing.EMPTY_HI
    meta = rng.randint(-2 ** 31, 2 ** 31, c, dtype=np.int64).astype(np.int32)
    pad = rng.randint(-2 ** 31, 2 ** 31, c, dtype=np.int64).astype(np.int32)
    b1, b2 = (b.numpy() for b in hashing.bucket_choices(q, c))
    pick = np.nonzero(rng.rand(q.shape[0]) < held)[0]
    second = {"b1": np.zeros(len(pick), bool), "b2": np.ones(len(pick), bool),
              "either": rng.rand(len(pick)) < 0.5}[side]
    slot = np.where(second, b2[pick], b1[pick]) * _B \
        + rng.randint(0, _B, len(pick))
    qn = q.numpy()
    lo[slot], hi[slot] = qn[pick, 0], qn[pick, 1]
    planes = np.stack([p.reshape(groups, _B) for p in (lo, hi, meta, pad)],
                      axis=1)
    return torch.from_numpy(planes.reshape(groups, 64).copy())


def _table(header, device):
    t = kv.create(4, header.shape[0] * _B, init_pool_rows=7, device="cpu")
    return dataclasses.replace(_to(t, device), header=header.to(device))


HEADER_CASES = {
    # name: (capacity, keys, free, tomb, held, side)
    "empty_table": (1024, 500, 1.0, 0.0, 0.0, "either"),
    "first_bucket_only": (1024, 500, 0.3, 0.1, 0.6, "b1"),
    "second_bucket_only": (1024, 500, 0.3, 0.1, 0.6, "b2"),
    "both_buckets_full": (1024, 500, 0.0, 0.0, 0.5, "either"),
    "tombstoned_lanes": (1024, 500, 0.0, 0.4, 0.5, "either"),
    "mostly_free": (4096, 700, 0.9, 0.05, 0.5, "either"),
    "two_buckets_moved": (32, 200, 0.4, 0.1, 0.5, "either"),
}


@pytest.mark.parametrize("want_pad", [False, True])
@pytest.mark.parametrize("name", sorted(HEADER_CASES))
def test_find_matches_the_plain_find(cuda, name, want_pad):
    cap, n, free, tomb, held, side = HEADER_CASES[name]
    rng = np.random.RandomState(sorted(HEADER_CASES).index(name) + 1)
    q = _keys(rng, n)
    # reserved ids: EMPTY, TOMBSTONE, and a neighbour of each that is not
    q = torch.cat([q, torch.tensor([[-1, -1], [-2, -1], [-3, -1], [-1, 0]],
                                   dtype=torch.int32)])
    header = _header(rng, cap // _B, q, free=free, tomb=tomb, held=held,
                     side=side)
    if name == "empty_table":
        header = kt._empty_header(cap // _B, "cpu")
    t = _table(header, cuda)
    qc = q.to(cuda)
    n_all = q.shape[0]
    for valid in (None, torch.from_numpy(rng.rand(n_all) < 0.7),
                  torch.zeros((n_all,), dtype=torch.bool)):
        vc = None if valid is None else valid.to(cuda)
        probed, found = _hold(t, qc, vc, want_pad)
        expect = n_all - 2 if valid is None else int(valid[:-4].sum()) \
            + int(valid[-2:].sum())
        assert probed == expect
        if valid is None and name != "empty_table" and held:
            assert found > 0
    if name == "two_buckets_moved":
        raw1 = hashing.hash_words(q, 0x2545F491) & 1
        raw2 = hashing.hash_words(q, 0x6A09E667) & 1
        assert bool((raw1 == raw2).any())      # some keys' b2 was moved


def test_no_key_launches_nothing(cuda):
    t = _table(kt._empty_header(64, "cpu"), cuda)
    q = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    for valid in (None, torch.zeros((0,), dtype=torch.bool, device=cuda)):
        for want_pad in (False, True):
            assert _hold(t, q, valid, want_pad) == (0, 0)


@pytest.mark.parametrize("cap,n", [
    (32, 1), (32, 2), (64, 17), (1 << 10, 15), (1 << 10, 16), (1 << 12, 33),
    (1 << 20, 2048), (1 << 23, 12288), (1 << 20, 1 << 18), (1 << 23, 1 << 18)])
def test_key_counts_and_capacities(cuda, cap, n):
    """From one key to 2^18 (a table load's), from 32 rows to BST's item
    table's 2^23, on a header a quarter held, half free."""
    rng = np.random.RandomState(cap % 9973 + n)
    q = _keys(rng, n)
    header = _header(rng, cap // _B, q, free=0.5, tomb=0.05, held=0.5)
    t = _table(header, cuda)
    qc = q.to(cuda)
    _hold(t, qc, None, False)
    _hold(t, qc, torch.from_numpy(rng.rand(n) < 0.9).to(cuda), True)


def test_int8_table_pad_plane(cuda):
    """``want_pad`` on an int8 serving table (``kv/quant.py``): the scales
    in the pad lanes come back bit for bit, and its lookup on the card
    equals the same lookup on a CPU copy."""
    rng = np.random.RandomState(21)
    t = kv.create(16, 1 << 12, device="cpu")
    ids = np.unique(rng.randint(1, 1 << 40, 2500).astype(np.int64))
    qi = hashing.encode_ids(ids, device="cpu")
    kv.insert(t, qi, torch.from_numpy(rng.randn(len(ids), 16)
                                      .astype(np.float32)))
    kv.delete(t, qi[:100])
    qt = quant.quantize_table(t)
    q = torch.cat([qi[:1500], _keys(rng, 300)])
    qt_card = _to(qt, cuda)
    _hold(qt_card, q.to(cuda), None, True)
    valid = torch.from_numpy(rng.rand(q.shape[0]) < 0.8)
    _hold(qt_card, q.to(cuda), valid.to(cuda), True)
    got = quant.lookup_or_zeros(qt_card, q.to(cuda), valid.to(cuda))
    want = quant.lookup_or_zeros(qt, q, valid)
    assert _same(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_dcn_shaped_lookup_matches_the_cpu(cuda, train):
    """A DCN table's lookup on the card (2^20 rows holding 2^18 ids, 2,048
    Zipf ids of which 5 % fresh, GroupAdam's slot columns): rows, slots,
    unique keys' order, meta, the header and the payload equal the same
    ``lookup_unique`` on a CPU copy, and the probe ran once."""
    rng = np.random.RandomState(5 + train)
    t_gpu = kv.ensure_slots(kv.create(64, 1 << 20, seed=3, device=cuda),
                            {"m": 1, "v": 1})
    held = np.unique(rng.randint(1, 1 << 62, (1 << 18) + 64,
                                 dtype=np.int64))[:1 << 18]
    kv.insert(t_gpu, hashing.encode_ids(held, device=cuda),
              torch.randn((len(held), 64), device=cuda))
    t_cpu = _to(t_gpu, "cpu")
    pick = np.minimum(rng.zipf(1.05, 2048) - 1, len(held) - 1)
    ids = held[pick]
    fresh = rng.rand(2048) < 0.05
    ids[fresh] = rng.randint(1 << 62, (1 << 63) - 1, int(fresh.sum()),
                             dtype=np.int64)
    out = {}
    for dev, t in (("cpu", t_cpu), ("cuda", t_gpu)):
        profiling.reset_counters()
        before = probe.probe.launches
        look, t2 = embedding.lookup_unique(t, ids, train=train, day=3)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert probe.probe.launches == before + 1
        out[dev] = (look, t2, _probe_counts())
    (l0, t0, c0), (l1, t1, c1) = out["cpu"], out["cuda"]
    for a, b in [(l0.rows, l1.rows), (l0.slot, l1.slot),
                 (l0.inverse, l1.inverse), (l0.counts, l1.counts),
                 (l0.num_unique, l1.num_unique),
                 (l0.payload_rows, l1.payload_rows),
                 (l0.meta_rows, l1.meta_rows),
                 (t0.header, t1.header), (t0.payload, t1.payload)]:
        assert _same(a, b)
    assert c0 == c1 and 0 < c1[1] < c1[0]


def test_one_find_is_one_kernel_in_its_span(cuda, tmp_path):
    """Traced on the card, a ``find`` opens one ``tfp::probe`` span and
    launches one kernel, the probe's, with no copy or fill beside it."""
    rng = np.random.RandomState(9)
    q = _keys(rng, 2048)
    t = _table(_header(rng, 1 << 12, q, free=0.3, tomb=0.1, held=0.7), cuda)
    qc = q.to(cuda)
    kv.find(t, qc)                      # the counter buffer exists now
    torch.cuda.synchronize()
    before = probe.probe.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kv.find(t, qc)
        torch.cuda.synchronize()
    assert probe.probe.launches == before + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "tfp::probe"
             and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    assert len(spans) == 1
    assert [("probe_kernel" in e["name"]) for e in device] == [True]


def test_probe_refuses_what_the_kernel_does_not_take(cuda):
    header = kt._empty_header(64, cuda)
    q = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        probe.probe(header.cpu(), q.cpu())
    with pytest.raises(TypeError):
        probe.probe(header, q.long())
    with pytest.raises(TypeError):
        probe.probe(header, q, torch.ones((8,), dtype=torch.int32,
                                          device=cuda))
    with pytest.raises(TypeError):
        probe.probe(header, q, torch.ones((7,), dtype=torch.bool,
                                          device=cuda))
    with pytest.raises(ValueError):
        probe.probe(kt._empty_header(48, cuda), q)
    with pytest.raises(TypeError):
        probe.probe(header[:, :32], q)
