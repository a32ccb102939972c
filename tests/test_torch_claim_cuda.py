"""The claim-insert kernel (``ops/csrc/claim.cu``) on the card, held bit for
bit against the table's Python claim rounds (``kv.table._claim_rounds``,
its plain version): the header, ``placed``, ``overflow``, the payload the
misses' initial rows land in, and the four insert counters. Cases: no
miss, one key, all misses, twins, keys whose two buckets are full (overflow
at half load), tombstoned slots, ``max_probes`` below 32, float32 and
bfloat16 payloads with slot columns, and key counts from a training
lookup's to 2^18 keys into an empty 2^20-row table; and a traced lookup on
the card opens no claim-round span. Marked ``cuda``: every test skips without a
card. On a machine with a card and without JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_claim_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from tfplus_tpu_torch import kv
from tfplus_tpu_torch.kv import hashing
from tfplus_tpu_torch.kv import table as kt
from tfplus_tpu_torch.ops import claim, rowops
from tfplus_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

INSERT_COUNTERS = ("misses", "claim_rounds", "inserted", "unplaced")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _to(table: kt.KvTable, device) -> kt.KvTable:
    """The table with every tensor copied to ``device``."""
    return dataclasses.replace(table, **{
        f.name: getattr(table, f.name).to(device)
        for f in dataclasses.fields(table)
        if isinstance(getattr(table, f.name), torch.Tensor)})


def _counts() -> dict:
    c = profiling.counters()
    return {k: c[k] for k in INSERT_COUNTERS}


def _ids(rng, n, lo=1, hi=1 << 40):
    return rng.randint(lo, hi, n).astype(np.int64)


def _table(rng, capacity, *, resident=0, tombstones=0, dim=8, max_probes=32,
           dtype=torch.float32, slots=None):
    """A CPU table holding ``resident`` random keys, the first
    ``tombstones`` of them deleted again; returns ``(table, resident ids)``."""
    t = kv.create(dim, capacity, max_probes=max_probes, init_pool_rows=97,
                  value_dtype=dtype, seed=int(rng.randint(1 << 30)),
                  device="cpu")
    if slots:
        t = kv.ensure_slots(t, slots)
    ids = np.unique(_ids(rng, resident))
    if len(ids):
        q = hashing.encode_ids(ids, device="cpu")
        rows = torch.from_numpy(rng.randn(len(ids), dim).astype(np.float32))
        kv.insert(t, q, rows.to(dtype))
        if tombstones:
            kv.delete(t, q[:tombstones])
    return t, ids


def _python_rounds(header, q, need, max_probes):
    """The CPU path's claim insert, run on ``header``'s device."""
    misses = kt._miss_gate(need)
    if not misses:
        return torch.full((q.shape[0],), -1, dtype=torch.int32,
                          device=header.device)
    return kt._claim_rounds(header, q, need, misses, max_probes)


def _hold_against_rounds(header, q, need, max_probes):
    """Claim ``q``'s ``need`` keys into two copies of ``header`` on the
    card, by the Python rounds and by the kernel: header, placed and
    counters are equal."""
    h_ref, h_ker = header.clone(), header.clone()
    profiling.reset_counters()
    p_ref = _python_rounds(h_ref, q, need, max_probes)
    c_ref = _counts()
    profiling.reset_counters()
    before = claim.claim_insert.launches
    p_ker = claim.claim_insert(h_ker, q, need, max_probes)
    torch.cuda.synchronize()
    c_ker = _counts()
    assert claim.claim_insert.launches == before + 1
    assert _same(h_ref, h_ker)
    assert _same(p_ref, p_ker)
    assert c_ref == c_ker
    assert c_ker["misses"] == c_ker["inserted"] + c_ker["unplaced"]
    return c_ker


CLAIM_CASES = {
    # name: (capacity, resident, tombstones, keys, twins, need share, probes)
    "no_miss": (1024, 0, 0, 64, 0, 0.0, 32),
    "one_key": (1024, 200, 0, 1, 0, 1.0, 32),
    "all_misses": (4096, 0, 0, 2048, 0, 1.0, 32),
    "twins": (1024, 100, 0, 300, 120, 1.0, 32),
    "half_load_overflow": (512, 0, 0, 512, 0, 1.0, 32),
    "tombstones": (1024, 400, 300, 500, 0, 0.9, 32),
    "few_probes": (1024, 300, 50, 600, 20, 1.0, 5),
    "seventeen_probes": (256, 0, 0, 256, 0, 1.0, 17),
}


@pytest.mark.parametrize("name", sorted(CLAIM_CASES))
def test_claim_matches_python_rounds(cuda, name):
    cap, resident, tomb, n, twins, share, probes = CLAIM_CASES[name]
    rng = np.random.RandomState(sorted(CLAIM_CASES).index(name) + 1)
    t, _ = _table(rng, cap, resident=resident, tombstones=tomb,
                  max_probes=probes)
    ids = _ids(rng, n)
    if twins:
        twin_of = ids[rng.randint(n, size=twins)]
        ids[rng.choice(n, twins, replace=False)] = twin_of
    q = hashing.encode_ids(ids, device=cuda)
    need = torch.from_numpy(rng.rand(n) < share).to(cuda)
    c = _hold_against_rounds(t.header.to(cuda), q, need, probes)
    if name == "half_load_overflow":
        assert c["unplaced"] > 0
    if name == "no_miss":
        assert c == dict.fromkeys(INSERT_COUNTERS, 0)


@pytest.mark.parametrize("n", [2048, 12288, 16385, 1 << 18])
def test_key_counts_match_python_rounds(cuda, n):
    """All fresh keys at a DCN table's and BST's item table's lookup sizes,
    above one block of the grid's width, and 2^18 keys into an empty
    2^20-row table (a benchmark table's load): the kernel leaves the Python
    rounds' header bit for bit."""
    rng = np.random.RandomState(n)
    cap = 1 << (4 * n - 1).bit_length()  # a power of two, at most a quarter full
    header = kt._empty_header(cap // 16, cuda)
    ids = np.unique(_ids(rng, n + 64))[:n]
    q = hashing.encode_ids(ids, device=cuda)
    need = torch.ones((n,), dtype=torch.bool, device=cuda)
    _hold_against_rounds(header, q, need, 32)


def test_a_rehash_spill_of_few_keys_in_many(cuda):
    """A call whose ``need`` holds few of its keys (the doubling's
    spill: every old slot is a key, a handful need a slot)."""
    rng = np.random.RandomState(7)
    t, ids = _table(rng, 1 << 16, resident=1 << 14, tombstones=500)
    header = t.header.to(cuda)
    keys = t.keys.to(cuda)
    need = torch.zeros((keys.shape[0],), dtype=torch.bool, device=cuda)
    pick = rng.choice(keys.shape[0], 40, replace=False)
    need[torch.from_numpy(pick).to(cuda)] = True
    fresh = hashing.encode_ids(_ids(rng, 40, 1 << 41, 1 << 42), device=cuda)
    keys[need] = fresh
    _hold_against_rounds(header, keys, need, 32)


@pytest.mark.parametrize("dtype,slots", [
    (torch.float32, None), (torch.float32, {"m": 1, "v": 1}),
    (torch.bfloat16, {"m": 1, "v": 1}), (torch.bfloat16, None)])
@pytest.mark.parametrize("n", [700, 16684])
def test_lookup_or_insert_matches_the_cpu(cuda, dtype, slots, n):
    """``lookup_or_insert`` on the card (one claim launch, then the ungated
    initial-row scatter) against the same call on a CPU copy (the Python
    rounds, ``_init_rows_for`` and the gated row scatter): header, payload,
    rows, slots, meta, overflow and counters byte for byte, on a table at
    half load with tombstones, where some ids overflow."""
    rng = np.random.RandomState(n + (dtype == torch.bfloat16))
    cap = 1 << 10 if n < 1000 else 1 << 15
    t_cpu, resident = _table(rng, cap, resident=cap // 2 - n // 4,
                             tombstones=cap // 16, dim=16, dtype=dtype,
                             slots=slots)
    t_gpu = _to(t_cpu, cuda)
    ids = np.concatenate([resident[:n // 2], _ids(rng, n - n // 2)])
    ids = np.unique(ids)
    counts = torch.from_numpy(rng.randint(1, 5, len(ids)).astype(np.int32))
    valid = torch.from_numpy(rng.rand(len(ids)) < 0.95)
    out = {}
    for dev, t in (("cpu", t_cpu), ("cuda", t_gpu)):
        profiling.reset_counters()
        before = claim.claim_insert.launches
        res = kv.lookup_or_insert(t, hashing.encode_ids(ids, device=dev),
                                  counts=counts.to(dev), valid=valid.to(dev),
                                  day=9)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert claim.claim_insert.launches == before + 1
        out[dev] = (res, t, _counts())
    (r0, t0, c0), (r1, t1, c1) = out["cpu"], out["cuda"]
    for a, b in [(t0.header, t1.header), (t0.payload, t1.payload),
                 (r0.rows, r1.rows), (r0.slot, r1.slot),
                 (r0.overflow, r1.overflow), (r0.meta_rows, r1.meta_rows),
                 (r0.payload_rows, r1.payload_rows)]:
        assert _same(a, b)
    assert c0 == c1 and c1["misses"] > 0
    assert c1["misses"] == c1["inserted"] + c1["unplaced"]


def test_initial_rows_round_as_torch_on_the_card(cuda):
    """The initial rows a lookup writes on the card equal
    ``_init_rows_for`` computed by torch there, float32 and bfloat16, with
    zero slot columns."""
    rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.bfloat16):
        t = kv.ensure_slots(kv.create(24, 1 << 12, init_pool_rows=101,
                                      value_dtype=dtype, seed=4,
                                      device=cuda), {"m": 2})
        ids = np.unique(_ids(rng, 1500))
        q = hashing.encode_ids(ids, device=cuda)
        res = kv.lookup_or_insert(t, q)
        ok = res.slot >= 0
        want = kt._init_rows_for(t, q)[ok]
        got = t.payload[res.slot[ok].long()]
        assert _same(got[:, :24], want)
        assert not bool(got[:, 24:].any())


def test_a_traced_lookup_on_the_card_opens_no_claim_round(cuda, tmp_path):
    """On the card the insert is one span around one claim launch and one
    row scatter: no ``tfp::claim_round``, and the counters still count the
    rounds."""
    rng = np.random.RandomState(5)
    t = kv.create(8, 1 << 12, seed=1, device=cuda)
    q = hashing.encode_ids(np.unique(_ids(rng, 900)), device=cuda)
    profiling.reset_counters()
    before = (claim.claim_insert.launches, rowops.scatter_rows.launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        kv.lookup_or_insert(t, q)
    names = [e.name for e in prof.events()]
    assert names.count("tfp::insert") == 1
    assert "tfp::claim_round" not in names
    assert claim.claim_insert.launches == before[0] + 1
    assert rowops.scatter_rows.launches == before[1] + 1
    c = _counts()
    assert c["claim_rounds"] >= 1 and c["inserted"] == q.shape[0]


def test_claim_refuses_what_the_kernel_does_not_take(cuda):
    header = kt._empty_header(64, cuda)
    q = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    need = torch.ones((8,), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        claim.claim_insert(header.cpu(), q.cpu(), need.cpu(), 32)
    with pytest.raises(ValueError):
        claim.claim_insert(header, q, need, 33)
    with pytest.raises(TypeError):
        claim.claim_insert(header, q.long(), need, 32)
    with pytest.raises(TypeError):
        claim.claim_insert(header, q, need.int(), 32)
    with pytest.raises(ValueError):
        claim.claim_insert(kt._empty_header(48, cuda), q, need, 32)
    pool = torch.zeros((5, 4), device=cuda)
    with pytest.raises(TypeError):
        claim.claim_insert(header, q, need, 32, pool=pool,
                           rows=torch.zeros((8, 4), dtype=torch.bfloat16,
                                            device=cuda))
    with pytest.raises(ValueError):
        claim.claim_insert(header, q, need, 32, pool=pool,
                           rows=torch.zeros((7, 4), device=cuda))
