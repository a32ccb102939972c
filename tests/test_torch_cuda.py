"""The port's CUDA kernels on the card.

Each row kernel is held bit for bit against its plain PyTorch version (these
are copies and single adds) at every class boundary of its launch plan
(rows of 1-1,024 elements in f32, bf16 and f16, tables 16-, 8-, 4- and
2-byte aligned, 1-32,768 indices with negative ones, C - 1 and C), reruns
bit for bit, and the plan itself is pinned to its rule; the table engine's
serving calls on the card leave
the same header and payload as the same calls on the CPU. Each flash-forward
kernel is held against its plain version at odd lengths (Sq 333 against
Skv 275/400, a single query row, fewer keys than one tile), head dims
8/64/128, f32 and bf16, causal, segments and dropout: f32 within ``atol =
rtol = 1e-5`` (another summation order; one flipped dropout bit moves an
output by ~1e-3), bf16 within ``1e-2`` (one bf16 ulp of the output); head
dims that the wrappers pad (12, 60) or that the CUDA-core kernels split
into 128-column chunks (136, 256) are held the same way, forward and
backward. bf16 at a padded D of 64/128 takes the tensor-core kernels and
everything else the CUDA-core ones (``flash_route``), which the per-route
launch counters show; a case with p_dropout 0.5 over 40 keys, where any
one flipped keep bit moves a result past the tolerance, holds each
tensor-core kernel's dropout bit for bit. BST and DIN
served on the card give the CPU's predictions within ``1e-5``. The flash
backward kernels are held against their plain versions (same limits) and
float64 autograd, run deterministically, and a CUDA backward never reaches
a plain version; the single-pass backward (dq, dk and dv in one launch,
padding skipped) is held against both plain backward versions over every
head dim its route takes, at the largest Skv that fits, with segments that
pad, differ between q and kv, meet no key or fill a whole batch row,
without segments, at Sq ≠ Skv and with dropout; a few DCN and BST training
steps on the card match the same steps on the CPU. The compactor kernel
matches its plain version bit for bit, and table growth, compaction,
export and a checkpoint round trip on the card leave the same tables as on
the CPU. Marked ``cuda``: every test skips without a card. On a machine
with a card and without JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tfplus_tpu_torch import checkpoint, kv, models
from tfplus_tpu_torch.ops import compactor
from tfplus_tpu_torch.ops import flash_attention as fa
from tfplus_tpu_torch.ops import rowops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _values(gen, c, w, dtype, device):
    return torch.randn(c, w, generator=gen).to(device=device, dtype=dtype)


# Every class boundary of the row kernels' plan: rows of 1-1,024 elements,
# in 2-, 4-, 8- and 16-byte words, 1-32 lanes, 1-8 words a lane.
ROW_WIDTHS = [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
              128, 129, 192, 256, 384, 512, 1024]
ROW_COUNTS = [1, 31, 32, 33, 2047, 2048, 32768]


def _aligned_views(gen, c, w, dtype, device):
    """``[c, w]`` views ``buf[k:].view(c, w)`` of one buffer whose base is
    16-, 8-, 4- and (2-byte types) 2-byte aligned: {alignment: view}."""
    esz = torch.empty((), dtype=dtype).element_size()
    buf = _values(gen, 1, c * w + 16, dtype, device)[0]
    assert buf.data_ptr() % 256 == 0
    return {a: buf[k:k + c * w].view(c, w)
            for a, k in ((16, 0), (8, 8 // esz), (4, 4 // esz), (2, 1))
            if a >= esz}


def _edge_indices(gen, c, n, unique):
    """n int32 indices into c rows with C - 1, a negative one and C (then
    C + 5) among them: unique (scatter) or with repeats (gather)."""
    edges = torch.tensor([c - 1, -1, c, -9, c + 5], dtype=torch.int32)
    if unique:
        rest = torch.randperm(c + 40, generator=gen).to(torch.int32) - 20
        rest = rest[~torch.isin(rest, edges)]
    else:
        rest = torch.randint(-7, c + 7, (n,), generator=gen,
                             dtype=torch.int32)
    return torch.cat([edges, rest])[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width", ROW_WIDTHS)
def test_gather_matches_plain(cuda, dtype, width):
    """Bit for bit against the plain version, at every count of rows and
    every alignment of the table, and again on a rerun."""
    gen = torch.Generator().manual_seed(width)
    c = 4099
    for align, values in _aligned_views(gen, c, width, dtype, cuda).items():
        for n in ROW_COUNTS:
            idx = _edge_indices(gen, c, n, unique=False).to(cuda)
            before = rowops.gather_rows.launches
            got = rowops.gather_rows(values, idx)
            assert rowops.gather_rows.launches == before + 1
            torch.cuda.synchronize()
            want = rowops.gather_rows_plain(values, idx)
            assert torch.equal(got, want), (align, n)
            assert torch.equal(rowops.gather_rows(values, idx), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width", ROW_WIDTHS)
@pytest.mark.parametrize("add", [False, True])
def test_scatter_matches_plain(cuda, dtype, width, add):
    """Bit for bit against the plain version (indices < 0 and >= C
    dropped), at every count of rows and every alignment of the table and
    the rows, and again on a rerun from the same table."""
    gen = torch.Generator().manual_seed(1000 + width)
    for n in ROW_COUNTS:
        c = 4099 if n < 4099 else n + 1000
        views = _aligned_views(gen, c, width, dtype, cuda)
        rows_at = _aligned_views(gen, n, width, dtype, cuda)
        for align, values in views.items():
            rows = rows_at[align]
            idx = _edge_indices(gen, c, n, unique=True).to(cuda)
            start = values.clone()
            want = rowops.scatter_rows_plain(values.clone(), idx, rows, add)
            before = rowops.scatter_rows.launches
            got = rowops.scatter_rows(values, idx, rows, add=add)
            assert got is values
            assert rowops.scatter_rows.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (align, n)
            again = rowops.scatter_rows(start, idx, rows, add=add)
            assert torch.equal(again, got)


def _expected_plan(row_bytes, n, align, sms):
    """The plan rule of csrc/rowops.cu, written out again."""
    wb = next(w for w in (16, 8, 4, 2) if row_bytes % w == 0
              and align % w == 0)
    words = row_bytes // wb
    lanes = 32 if words >= 32 else 1 << (words - 1).bit_length()
    k = min(8, 1 << (-(-words // 32) - 1).bit_length()) if words > 32 else 1
    u = 2 if k == 1 and n > 2 * sms * 64 * (32 // lanes) else 1
    return wb, lanes, k, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_rowops_plan_pins_the_classes(cuda, dtype):
    """``tfp_rowops_plan`` at every class boundary: the word, the lanes per
    row, the words per lane and the rows in flight follow the rule, and
    the grid gives every tile of rows a warp."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    esz = torch.empty((), dtype=dtype).element_size()
    pinned = {(torch.float32, 1): (4, 1, 1), (torch.float32, 2): (8, 1, 1),
              (torch.float32, 3): (4, 4, 1), (torch.float32, 64): (16, 16, 1),
              (torch.float32, 512): (16, 32, 4),
              (torch.float32, 1024): (16, 32, 8),
              (torch.bfloat16, 5): (2, 8, 1), (torch.bfloat16, 64): (16, 8, 1),
              (torch.bfloat16, 128): (16, 16, 1)}
    kinds = ["gather", "set", "add"]
    for width in ROW_WIDTHS:
        for align in (16, 8, 4, 2):
            if align < esz:
                continue
            for n in ROW_COUNTS + [1 << 19]:
                for kind in kinds:
                    got = rowops.plan(width * esz, n, align=align,
                                      dtype=dtype, kind=kind)
                    want = _expected_plan(width * esz, n, align, sms)
                    assert (got["word_bytes"], got["lanes_per_row"],
                            got["words_per_lane"],
                            got["rows_in_flight"]) == want
                    if align == 16 and (dtype, width) in pinned:
                        assert want[:3] == pinned[dtype, width]
                    rows_per_block = (8 * (32 // got["lanes_per_row"])
                                      * got["rows_in_flight"])
                    assert got["block"] == 256
                    assert got["grid"] == -(-n // rows_per_block)
    with pytest.raises(RuntimeError):
        rowops.plan(0, 10)


@pytest.mark.parametrize("width", [1, 3, 64, 512])
def test_timed_only_launches_match_plain(cuda, width):
    """The earlier kernels, which chip_smoke.py times beside the wrappers,
    compute the same rows and count nothing."""
    gen = torch.Generator().manual_seed(50 + width)
    c, n = 5000, 3000
    values = _values(gen, c, width, torch.float32, cuda)
    rows = _values(gen, n, width, torch.float32, cuda)
    gidx = _edge_indices(gen, c, n, unique=False).to(cuda)
    sidx = _edge_indices(gen, c, n, unique=True).to(cuda)
    counts = (rowops.gather_rows.launches, rowops.scatter_rows.launches)
    want = rowops.gather_rows_plain(values, gidx)
    assert torch.equal(rowops._gather_rows_earlier(values, gidx), want)
    for add in (False, True):
        want = rowops.scatter_rows_plain(values.clone(), sidx, rows, add)
        got = rowops._scatter_rows_earlier(values.clone(), sidx, rows, add)
        assert torch.equal(got, want)
    assert (rowops.gather_rows.launches,
            rowops.scatter_rows.launches) == counts


def test_misaligned_rows_take_the_narrow_words(cuda):
    gen = torch.Generator().manual_seed(7)
    c, w = 1000, 8
    buf = torch.randn(c * w + 1, generator=gen).to(cuda)
    values = buf[1:].view(c, w)                    # 4-byte aligned only
    idx = torch.randint(0, c, (700,), generator=gen,
                        dtype=torch.int32).to(cuda)
    assert torch.equal(rowops.gather_rows(values, idx),
                       rowops.gather_rows_plain(values, idx))
    rows = torch.randn(700, w, generator=gen).to(cuda)
    uidx = torch.randperm(c, generator=gen)[:700].to(torch.int32).to(cuda)
    want = rowops.scatter_rows_plain(values.clone(), uidx, rows)
    assert torch.equal(rowops.scatter_rows(values, uidx, rows), want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    values = torch.zeros(16, 8, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rowops.gather_rows(values[:, :4], idx)             # not contiguous
    with pytest.raises(TypeError):
        rowops.gather_rows(values, idx.long())
    with pytest.raises(ValueError):
        rowops.gather_rows(values, idx.cpu())               # two devices
    with pytest.raises(TypeError):
        rowops.scatter_rows(values.double(), idx,
                            torch.zeros(4, 8, device=cuda,
                                        dtype=torch.double))


def test_serving_calls_on_the_card_match_the_cpu(cuda):
    """The same table calls on the card (kernels) and on the CPU (plain
    versions) leave bit-identical tables and return identical rows."""
    rng = np.random.RandomState(3)
    tables = {d: kv.create(16, 1024, max_probes=8, init_pool_rows=100,
                           seed=5, device=d) for d in ("cpu", cuda)}
    ids = rng.randint(0, 1 << 40, 600).astype(np.int64)
    more = rng.randint(0, 1 << 40, 200).astype(np.int64)
    rows = rng.randn(200, 16).astype(np.float32)
    out = {}
    for d, t in tables.items():
        res = kv.lookup_or_insert(t, kv.encode_ids(ids, device=d), day=3)
        kv.insert(t, kv.encode_ids(more, device=d),
                  torch.from_numpy(rows).to(d), day=4)
        probe = kv.encode_ids(np.concatenate([ids[::3], more, more + 1]),
                              device=d)
        out[d] = (res.rows, res.slot, kv.lookup_or_zeros(t, probe),
                  kv.lookup_with_init(t, probe), t.header, t.payload)
    for a, b in zip(out["cpu"], out[cuda]):
        assert torch.equal(a, b.cpu())


# ---------------------------------------------------------------------------
# flash-attention forward
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _attention_inputs(seed, b, h, sq, skv, d, dtype, device, segments):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(device=device,
                                                          dtype=dtype)
               for s in (sq, skv, skv))
    qs = ks = None
    if segments:
        ks = torch.randint(-1, 3, (b, skv), generator=gen, dtype=torch.int32)
        ks = ks.sort(dim=1).values                 # padding first, then runs
        qs = ks[:, :sq] if sq <= skv else torch.cat(
            [ks, torch.full((b, sq - skv), -1, dtype=torch.int32)], 1)
        qs, ks = qs.contiguous().to(device), ks.to(device)
    return q, k, v, qs, ks


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   **FLASH_TOL[dtype if g.dtype == dtype
                                               else torch.float32])


def _lengths(lengths, causal):
    """(Sq, Skv): odd lengths that divide no tile, one query row, or fewer
    keys than one 64-key tile."""
    return {"odd": (333, 275 if causal else 400), "one_row": (1, 40),
            "short_kv": (150, 40)}[lengths]


def _route_counts(fn):
    return fn.launches, fn.tc_launches, fn.cuda_core_launches


def _assert_one_launch(fn, before, dtype, d):
    """One launch more, on the route that dtype and D pick: bf16 at a
    padded D of 64 or 128 on the tensor cores, everything else on the CUDA
    cores."""
    route = ("tc" if dtype == torch.bfloat16
             and fa.padded_head_dim(d) in (64, 128) else "cuda_core")
    assert fa.flash_route(dtype, d) == route
    want = (before[0] + 1, before[1] + (route == "tc"),
            before[2] + (route == "cuda_core"))
    assert _route_counts(fn) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("causal,segments,p_dropout", [
    (False, False, 0.0), (True, False, 0.0), (False, True, 0.0),
    (True, True, 0.2), (False, True, 0.2)])
@pytest.mark.parametrize("lengths", ["odd", "one_row", "short_kv"])
def test_flash_fwd_matches_plain(cuda, dtype, d, causal, segments, p_dropout,
                                 lengths):
    b, h = 2, 3
    sq, skv = _lengths(lengths, causal)
    q, k, v, qs, ks = _attention_inputs(d, b, h, sq, skv, d, dtype, cuda,
                                        segments)
    before = _route_counts(fa.flash_fwd)
    got = fa.flash_fwd(q, k, v, qs, ks, 11, causal=causal, sm_scale=0.2,
                       p_dropout=p_dropout)
    _assert_one_launch(fa.flash_fwd, before, dtype, d)
    torch.cuda.synchronize()
    want = fa.fwd_tiled_plain(q, k, v, qs, ks, 11, causal=causal,
                              sm_scale=0.2, p_dropout=p_dropout)
    _assert_close(got, want, dtype)
    out, l_, m_ = fa.flash_fwd(q, k, v, qs, ks, 11, causal=causal,
                               sm_scale=0.2, p_dropout=p_dropout,
                               save_residuals=False)
    assert l_ is None and m_ is None
    assert torch.equal(out, got[0])


# (dtype, D, Sq, Skv): odd and round lengths, Sq != Skv both ways (the long
# query of the Sq 1000 case), and the largest Skv that single_fits admits at
# f32 D 8 and bf16 D 64 and 128
SINGLE_FWD_SHAPES = [
    (torch.float32, 8, 200, 200), (torch.bfloat16, 8, 200, 200),
    (torch.float32, 8, 128, 128), (torch.float32, 64, 60, 60),
    (torch.bfloat16, 64, 100, 100), (torch.bfloat16, 128, 40, 40),
    (torch.float32, 32, 1000, 128), (torch.float32, 8, 77, 150),
    (torch.float32, 8, 320, 320), (torch.bfloat16, 64, 192, 192),
    (torch.bfloat16, 128, 64, 64)]


@pytest.mark.parametrize("dtype,d,sq,skv", SINGLE_FWD_SHAPES)
@pytest.mark.parametrize("segments", ["sorted", "bst", "differ", "none"])
@pytest.mark.parametrize("p_dropout", [0.0, 0.2])
def test_flash_fwd_single_matches_plain(cuda, dtype, d, sq, skv, segments,
                                        p_dropout):
    """The single-pass forward against ``fwd_single_plain`` (f32 within
    1e-5: another summation order; bf16 within 1e-2). Segments: "sorted"
    (runs of -1, 0, 1, 2), "bst" (BST's layout, the candidate at 20, the
    last batch row all padding, and batch row 1's keys all padding),
    "differ" (q and kv ids apart, a q segment that meets no key) or none.
    Rows that hit no key give out 0, l 0 and m = mask_value exactly; the
    tiled kernel computes the same function."""
    assert fa.single_fits(skv, d, dtype)
    if segments == "sorted":
        q, k, v, qs, ks = _attention_inputs(sq + d, 3, 2, sq, skv, d, dtype,
                                            cuda, True)
    else:
        q, k, v, _, _ = _attention_inputs(sq + d, 3, 2, sq, skv, d, dtype,
                                          cuda, False)
        gen = torch.Generator().manual_seed(sq + skv)
        qs, ks = _single_segments(gen, 3, sq, skv, segments, cuda)
        if segments == "bst":
            ks[1] = -1
    before = fa.flash_fwd_single.launches
    got = fa.flash_fwd_single(q, k, v, qs, ks, -3, sm_scale=0.3,
                              p_dropout=p_dropout)
    assert fa.flash_fwd_single.launches == before + 1
    torch.cuda.synchronize()
    want = fa.fwd_single_plain(q, k, v, qs, ks, -3, sm_scale=0.3,
                               p_dropout=p_dropout)
    _assert_close(got, want, dtype)
    out, l, m = got
    never = want[1] == 0
    assert torch.equal(never, l == 0)
    assert (out.float()[never] == 0).all()
    assert (m[never] == torch.tensor(fa.DEFAULT_MASK_VALUE)).all()
    if segments == "bst":
        assert never[1].all() and never[-1].all()
    # the tiled kernel computes the same function
    _assert_close(got, fa.flash_fwd(q, k, v, qs, ks, -3, causal=False,
                                    sm_scale=0.3, p_dropout=p_dropout),
                  dtype)


def test_flash_fwd_single_reruns_bit_identical(cuda):
    """No atomics: at BST's heads with its segments and dropout, reruns
    give out, l and m bit for bit; so do other splits of the rows and heads
    across blocks (each row is computed the same way in any block)."""
    gen = torch.Generator().manual_seed(3)
    b, h, s, d = 64, 8, 128, 8
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(cuda)
               for _ in range(3))
    qs, ks = _single_segments(gen, b, s, s, "bst", cuda)
    kw = dict(sm_scale=0.35, p_dropout=0.2)
    got = fa.flash_fwd_single(q, k, v, qs, ks, 5, **kw)
    for _ in range(3):
        again = fa.flash_fwd_single(q, k, v, qs, ks, 5, **kw)
        assert all(torch.equal(x, y) for x, y in zip(again, got))
    for rows in (fa.single_fwd_tile(d, True), 128):
        for heads in (1, 3, 8):
            again = fa._launch(fa._flash_fwd_single_lib(),
                               "tfp_flash_fwd_single_skip", q, k, v, qs, ks,
                               5, 0.35, 0.2, True, mid=(rows, heads))
            assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_fwd_smem_bytes_mirrors_the_kernel(cuda, dtype):
    """The Python mirror of the kernel's shared-memory layout gives the
    kernel's own size at every padded D, Skv 1-320, every count of rows
    per block that the kernel takes, with segments and without."""
    lib = fa._flash_fwd_single_lib()
    code = fa._DTYPES[dtype]
    for d in range(8, 129, 8):
        for seg in (False, True):
            tile = fa.single_fwd_tile(d, seg)
            for skv in (1, 7, 64, 65, 128, 200, 320):
                for rows in range(tile, 129, tile):
                    assert lib.tfp_flash_fwd_single_skip_smem(
                        d, skv, code, rows, seg) == fa.single_fwd_smem_bytes(
                            skv, d, dtype, rows, seg)


def _flipped_bit_moves(p, x, tol):
    """Whether flipping any one keep bit of the inverted dropout at 0.5
    (which adds or removes 2·p·x, with x the value that p weighs) moves some
    element of the result by more than ``tol`` (atol + rtol·|result|): the
    least such move over all (row, key) pairs, over tol."""
    move = (2 * p[..., None] * x[:, :, None]).abs()     # [B, H, Sq, Skv, D]
    return float((move / tol[:, :, :, None]).amax(-1).min())


def test_flash_fwd_tc_dropout_is_bit_exact(cuda):
    """bf16 D64 over 40 keys at p_dropout 0.5 with nearly flat scores: any
    one flipped keep bit would move an output past the bf16 tolerance, so
    passing holds the tensor-core forward's dropout to the plain version's
    mask bit for bit."""
    q, k, v, _, _ = _attention_inputs(31, 2, 3, 70, 40, 64, torch.bfloat16,
                                      cuda, False)
    kw = dict(causal=False, sm_scale=0.01, p_dropout=0.5)
    before = _route_counts(fa.flash_fwd)
    got = fa.flash_fwd(q, k, v, None, None, 9, **kw)
    _assert_one_launch(fa.flash_fwd, before, torch.bfloat16, 64)
    torch.cuda.synchronize()
    want = fa.fwd_tiled_plain(q, k, v, None, None, 9, **kw)
    _assert_close(got, want, torch.bfloat16)
    p = torch.softmax(0.01 * q.double() @ k.double().transpose(-1, -2), -1)
    tol = 1e-2 + 1e-2 * want[0].double().abs()
    assert _flipped_bit_moves(p, v.double(), tol) > 1


def test_cuda_calls_never_run_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(fa, "fwd_single_plain", refuse)
    monkeypatch.setattr(fa, "fwd_tiled_plain", refuse)
    q, k, v, _, _ = _attention_inputs(0, 2, 8, 150, 150, 8, torch.float32,
                                      cuda, False)
    launches = fa.flash_fwd.launches, fa.flash_fwd_single.launches
    routes = fa.flash_fwd.tc_launches, fa.flash_fwd.cuda_core_launches
    fa.flash_attention(q, k, v)                              # single
    fa.flash_attention(q, k, v, causal=True)                 # tiled
    out, lse = fa.flash_attention_with_lse(q, k, v, p_dropout=0.1)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd_single.launches) == (
        launches[0] + 1, launches[1] + 2)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    # bf16 at D 64 and 128: the tensor-core route, causal and not
    for d in (64, 128):
        q, k, v, _, _ = _attention_inputs(d, 2, 4, 300, 300, d,
                                          torch.bfloat16, cuda, False)
        out = fa.flash_attention(q, k, v, causal=True)
        out2, lse = fa.flash_attention_with_lse(q, k, v, p_dropout=0.1)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in (out, out2, lse))
    assert (fa.flash_fwd.tc_launches, fa.flash_fwd.cuda_core_launches) == (
        routes[0] + 4, routes[1] + 1)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 1, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3), q, q, None, None, 0, causal=False,
                     sm_scale=1.0)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), q.half(), q.half(), None, None, 0,
                     causal=False, sm_scale=1.0)
    big = torch.zeros(1, 1, 4096, 128, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_fwd_single(big, big, big, None, None, 0, sm_scale=1.0)
    wide = torch.zeros(1, 1, 16, 136, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_fwd_single(wide, wide, wide, None, None, 0, sm_scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 60, 136, 256])
@pytest.mark.parametrize("causal,segments", [(True, True), (False, False)])
def test_flash_any_head_dim_matches_plain(cuda, dtype, d, causal, segments):
    """Any D, as the JAX kernels take it: 12 and 60 are zero-padded to 16
    and 64 (bf16 D 60 then takes the tensor cores), 136 and 256 run the
    CUDA-core kernels in 128-column chunks. Forward (tiled, and single-pass
    where it fits), dk/dv and dq against their plain versions at the
    unpadded D (limits as above), outputs of the caller's D."""
    b, h, s = 1, 2, 200
    q, k, v, qs, ks = _attention_inputs(d, b, h, s, s, d, dtype, cuda,
                                        segments)
    kw = dict(causal=causal, sm_scale=0.2, p_dropout=0.1)
    before = _route_counts(fa.flash_fwd)
    got = fa.flash_fwd(q, k, v, qs, ks, 7, **kw)
    _assert_one_launch(fa.flash_fwd, before, dtype, d)
    torch.cuda.synchronize()
    assert got[0].shape == q.shape and got[0].is_contiguous()
    _assert_close(got, fa.fwd_tiled_plain(q, k, v, qs, ks, 7, **kw), dtype)
    if not causal and fa.single_fits(s, d, dtype):
        single = dict(sm_scale=0.2, p_dropout=0.1)
        _assert_close(fa.flash_fwd_single(q, k, v, qs, ks, 7, **single),
                      fa.fwd_single_plain(q, k, v, qs, ks, 7, **single),
                      dtype)
    out, l, m = got
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(
        device=cuda, dtype=dtype)
    args = (q, k, v, qs, ks, 7, do, l, m, fa._delta(do, out))
    before = _route_counts(fa.flash_bwd_dkv), _route_counts(fa.flash_bwd_dq)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    dq = fa.flash_bwd_dq(*args, **kw)
    _assert_one_launch(fa.flash_bwd_dkv, before[0], dtype, d)
    _assert_one_launch(fa.flash_bwd_dq, before[1], dtype, d)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    _assert_close((dq, dk, dv), (fa.bwd_dq_plain(*args, **kw),
                                 *fa.bwd_dkv_plain(*args, **kw)), dtype)


def _small_sequence_model(name):
    if name == "BST":
        return models.BST(embedding_dim=16, seq_len=7, num_numeric=3,
                          num_heads=2, head_dim=8, ffn_hidden=32,
                          dnn_hidden=(16, 8), capacity=1024)
    return models.DIN(embedding_dim=16, seq_len=7, num_numeric=3,
                      dnn_hidden=(16, 8), capacity=1024)


@pytest.mark.parametrize("name", ["BST", "DIN"])
def test_sequence_models_serve_the_same_on_the_card(cuda, name):
    """The same tables, weights and batch on the card and on the CPU give
    the same predictions (f32, another summation order: 1e-5)."""
    model = _small_sequence_model(name)
    rng = np.random.RandomState(4)
    keys = rng.randint(1, 1 << 40, 300).astype(np.int64)
    rows = rng.randn(300, 16).astype(np.float32)
    lengths = rng.randint(0, 8, 64)
    mask = (np.arange(7)[None, :] < lengths[:, None]).astype(np.float32)
    seq = np.where(mask > 0, rng.choice(keys, (64, 7)), 0)
    batch = {"ids": {"item": model.pack_item_ids(rng.choice(keys, 64), seq),
                     "user": rng.choice(keys, 64)},
             "features": {"numeric": rng.randn(64, 3).astype(np.float32),
                          "mask": mask},
             "labels": rng.randint(0, 2, 64).astype(np.float32)}
    batch["ids"]["user"][:5] += 1 << 41                 # unknown users
    out = {}
    for dev in ("cpu", cuda):
        state = models.init_state(model, seed=2, device=dev)
        for t in state.tables.values():
            kv.insert(t, kv.encode_ids(keys, device=dev),
                      torch.from_numpy(rows).to(dev), day=1)
        launches = fa.flash_fwd_single.launches
        _, loss, preds = models.make_train_step(model, train=False)(
            state, batch)
        if dev != "cpu" and name == "BST":
            assert fa.flash_fwd_single.launches == launches + 1
        out[str(dev)] = (preds.cpu(), loss.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------

def _backward_inputs(seed, b, h, sq, skv, d, dtype, device, segments,
                     causal, p_dropout):
    q, k, v, qs, ks = _attention_inputs(seed, b, h, sq, skv, d, dtype, device,
                                        segments)
    out, l, m = fa.flash_fwd(q, k, v, qs, ks, 5, causal=causal, sm_scale=0.2,
                             p_dropout=p_dropout)
    gen = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen).to(device=device, dtype=dtype)
    return q, k, v, qs, ks, do, l, m, fa._delta(do, out), out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("causal,segments,p_dropout", [
    (False, False, 0.0), (True, False, 0.0), (False, True, 0.0),
    (True, True, 0.2), (False, True, 0.2)])
@pytest.mark.parametrize("lengths", ["odd", "one_row", "short_kv"])
def test_flash_bwd_matches_plain(cuda, dtype, d, causal, segments, p_dropout,
                                 lengths):
    """Both backward kernels at odd lengths against their plain versions
    (bf16 at D 64/128 on the tensor-core route, dk/dv and dq both):
    f32 within 1e-5 (another summation order; one flipped dropout bit moves
    a gradient by ~1e-2), bf16 within 1e-2 (an intermediate that rounds the
    other way moves a gradient by a bf16 ulp of one term)."""
    b, h = 2, 3
    sq, skv = _lengths(lengths, causal)
    q, k, v, qs, ks, do, l, m, di, _ = _backward_inputs(
        d + 100, b, h, sq, skv, d, dtype, cuda, segments, causal, p_dropout)
    kw = dict(causal=causal, sm_scale=0.2, p_dropout=p_dropout)
    before = _route_counts(fa.flash_bwd_dkv), _route_counts(fa.flash_bwd_dq)
    dk, dv = fa.flash_bwd_dkv(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    dq = fa.flash_bwd_dq(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    _assert_one_launch(fa.flash_bwd_dkv, before[0], dtype, d)
    _assert_one_launch(fa.flash_bwd_dq, before[1], dtype, d)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.bwd_dkv_plain(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    want_dq = fa.bwd_dq_plain(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    _assert_close((dq, dk, dv), (want_dq, want_dk, want_dv), dtype)
    # a rerun is bit-identical (no atomics)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, qs, ks, 5, do, l, m, di, **kw),
                       dq)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        fa.flash_bwd_dkv(q, k, v, qs, ks, 5, do, l, m, di, **kw), (dk, dv)))


def test_flash_bwd_dkv_tc_dropout_is_bit_exact(cuda):
    """bf16 D128 over 40 keys at p_dropout 0.5 with nearly flat scores: any
    one flipped keep bit would move a dv element past the bf16 tolerance,
    so passing holds the tensor-core dk/dv kernel's dropout to the plain
    version's mask bit for bit; a rerun is bit-identical."""
    q, k, v, _, _ = _attention_inputs(41, 2, 3, 70, 40, 128, torch.bfloat16,
                                      cuda, False)
    kw = dict(causal=False, sm_scale=0.01, p_dropout=0.5)
    out, l, m = fa.flash_fwd(q, k, v, None, None, 3, **kw)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(
        device=cuda, dtype=torch.bfloat16)
    di = fa._delta(do, out)
    before = _route_counts(fa.flash_bwd_dkv)
    got = fa.flash_bwd_dkv(q, k, v, None, None, 3, do, l, m, di, **kw)
    _assert_one_launch(fa.flash_bwd_dkv, before, torch.bfloat16, 128)
    torch.cuda.synchronize()
    want = fa.bwd_dkv_plain(q, k, v, None, None, 3, do, l, m, di, **kw)
    _assert_close(got, want, torch.bfloat16)
    again = fa.flash_bwd_dkv(q, k, v, None, None, 3, do, l, m, di, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    # dv[key] = sum over rows of p_d[row, key] do[row]: a flip at (row, key)
    # moves dv[key] by 2 p do[row]
    p = torch.softmax(0.01 * q.double() @ k.double().transpose(-1, -2), -1)
    tol = 1e-2 + 1e-2 * want[1].double().abs()            # [B, H, Skv, D]
    move = (2 * p[..., None] * do.double()[:, :, :, None]).abs()
    assert float((move / tol[:, :, None]).amax(-1).min()) > 1


def test_flash_bwd_dq_tc_dropout_is_bit_exact(cuda):
    """bf16 D128 over 40 keys at p_dropout 0.5 with nearly flat scores
    (q scaled to 0.01) and do, v shifted by 3, so that every dp = do·vᵀ is
    large: a flipped keep bit at (row, key) moves ds by 2·p·dp·sm_scale and
    dq[row] by that times k[key], which for every pair passes the bf16
    tolerance in some column, so passing holds the tensor-core dq kernel's
    dropout to the plain version's mask bit for bit; a rerun is
    bit-identical."""
    gen = torch.Generator().manual_seed(43)
    b, h, sq, skv, d = 2, 3, 70, 40, 128
    q = 0.01 * torch.randn(b, h, sq, d, generator=gen)
    k = torch.randn(b, h, skv, d, generator=gen)
    v = torch.randn(b, h, skv, d, generator=gen) + 3
    do = torch.randn(b, h, sq, d, generator=gen) + 3
    q, k, v, do = (t.to(device=cuda, dtype=torch.bfloat16)
                   for t in (q, k, v, do))
    kw = dict(causal=False, sm_scale=1.0, p_dropout=0.5)
    out, l, m = fa.flash_fwd(q, k, v, None, None, 3, **kw)
    args = (q, k, v, None, None, 3, do, l, m, fa._delta(do, out))
    before = _route_counts(fa.flash_bwd_dq)
    got = fa.flash_bwd_dq(*args, **kw)
    _assert_one_launch(fa.flash_bwd_dq, before, torch.bfloat16, d)
    torch.cuda.synchronize()
    want = fa.bwd_dq_plain(*args, **kw)
    _assert_close([got], [want], torch.bfloat16)
    assert torch.equal(fa.flash_bwd_dq(*args, **kw), got)
    p = torch.softmax(q.double() @ k.double().transpose(-1, -2), -1)
    dp = do.double() @ v.double().transpose(-1, -2)        # [B, H, Sq, Skv]
    tol = 1e-2 + 1e-2 * want.double().abs()                # [B, H, Sq, D]
    move = (2 * p * dp.abs())[..., None] * k.double().abs()[:, :, None]
    assert float((move / tol[:, :, :, None]).amax(-1).min()) > 1


def test_flash_gradients_on_the_card_match_float64(cuda):
    """``flash_attention``'s autograd through both backward kernels against
    float64 autograd through ``reference_attention`` (f32, within 1e-5 of
    the gradients' scale)."""
    q, k, v, qs, ks = _attention_inputs(3, 2, 4, 200, 200, 32, torch.float32,
                                        cuda, True)
    do = torch.randn(q.shape, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, q_segment_ids=qs,
                             kv_segment_ids=ks, p_dropout=0.1,
                             dropout_seed=4)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.double().requires_grad_() for t in (q, k, v)]
    ref = fa.reference_attention(*ref_leaves, causal=True, q_segment_ids=qs,
                                 kv_segment_ids=ks, p_dropout=0.1,
                                 dropout_seed=4)
    want = torch.autograd.grad(ref, ref_leaves, do.double())
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g.double() - w).abs().max()) <= 1e-5 * scale


def test_cuda_backward_never_runs_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("bwd_plain", "bwd_dkv_plain", "bwd_dq_plain",
                 "fwd_single_plain", "fwd_tiled_plain", "reference_attention"):
        monkeypatch.setattr(fa, name, refuse)
    launches = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
                fa.flash_bwd_single.launches)
    routes = [_route_counts(fn)[1:] for fn in (fa.flash_bwd_dkv,
                                                fa.flash_bwd_dq)]
    # f32 D8 (CUDA cores), then bf16 D64 and D128 (tensor cores)
    for dtype, d in ((torch.float32, 8), (torch.bfloat16, 64),
                     (torch.bfloat16, 128)):
        for causal in (False, True):
            q, k, v, _, _ = _attention_inputs(0, 2, 8, 150, 150, d, dtype,
                                              cuda, False)
            leaves = [t.requires_grad_() for t in (q, k, v)]
            fa.flash_attention(*leaves, causal=causal).float().sum().backward()
            assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    torch.cuda.synchronize()
    # f32 D8 non-causal takes the single-pass backward; the rest dk/dv and
    # dq (bf16 D64 keeps the tensor cores though its KV fits the block)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_single.launches) == (
        launches[0] + 5, launches[1] + 5, launches[2] + 1)
    for fn, (tc, cuda_core) in zip((fa.flash_bwd_dkv, fa.flash_bwd_dq),
                                   routes):
        assert _route_counts(fn)[1:] == (tc + 4, cuda_core + 1)


def _max_single_skv(d, dtype):
    """The largest Skv that :func:`fa.single_fits` admits at this D."""
    skv = 1
    while fa.single_fits(skv + 1, d, dtype):
        skv += 1
    return skv


def _single_segments(gen, b, sq, skv, mode, device):
    """Segment ids for the single-pass backward. "bst": BST's layout, a
    history prefix of 0-20 tokens and the candidate at position 20, the rest
    padding (−1), q and kv alike up to the shorter length; "differ": q and
    kv ids drawn apart from {−1, 0, 1, 2}, with no key of segment 2 in batch
    row 0, so its q rows of segment 2 meet no key (l = 0). Either way the
    last batch row is all padding on the q side. "none": no segments."""
    if mode == "none":
        return None, None

    def bst(n):
        ids = torch.full((b, n), -1, dtype=torch.int32)
        hist = torch.randint(0, 21, (b,), generator=gen)
        for i in range(b):
            ids[i, :min(int(hist[i]), n)] = 0
            if n > 20:
                ids[i, 20] = 0
        return ids

    if mode == "bst":
        qs, ks = bst(sq), bst(skv)
    else:
        qs = torch.randint(-1, 3, (b, sq), generator=gen, dtype=torch.int32)
        ks = torch.randint(-1, 3, (b, skv), generator=gen, dtype=torch.int32)
        ks[0] = torch.where(ks[0] == 2, 1, ks[0])
        qs[0, :4] = 2
    qs[-1] = -1
    return qs.to(device), ks.to(device)


# (dtype, D, Sq, Skv): every D the route takes (f32 D 8, 16, 32 and bf16 D 16
# at the largest Skv that fits; D 12 padded to 16), and Sq != Skv both ways
SINGLE_SHAPES = [
    (torch.float32, 8, None, None), (torch.float32, 16, None, None),
    (torch.float32, 32, None, None), (torch.bfloat16, 16, None, None),
    (torch.float32, 12, 130, 130), (torch.float32, 8, 1000, 128),
    (torch.float32, 32, 77, 150), (torch.bfloat16, 16, 200, 60)]


@pytest.mark.parametrize("dtype,d,sq,skv", SINGLE_SHAPES)
@pytest.mark.parametrize("segments", ["bst", "differ", "none"])
@pytest.mark.parametrize("p_dropout", [0.0, 0.3])
def test_flash_bwd_single_matches_plain(cuda, dtype, d, sq, skv, segments,
                                        p_dropout):
    """dq, dk and dv in one launch against ``bwd_dq_plain`` and
    ``bwd_dkv_plain`` (f32 within 1e-5: another summation order; bf16
    within 1e-2), from the single-pass forward's residuals; rows and keys
    on padding get exact zeros."""
    if sq is None:
        sq = skv = _max_single_skv(d, dtype)
    assert fa.single_fits(skv, d, dtype)
    assert fa.flash_route(dtype, d) == "cuda_core"
    gen = torch.Generator().manual_seed(sq + skv + d)
    b, h = 3, 2
    q, do = (torch.randn(b, h, sq, d, generator=gen).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=gen).to(cuda, dtype)
            for _ in range(2))
    qs, ks = _single_segments(gen, b, sq, skv, segments, cuda)
    out, l, m = fa.flash_fwd_single(q, k, v, qs, ks, 13, sm_scale=0.3,
                                    p_dropout=p_dropout)
    args = (q, k, v, qs, ks, 13, do, l, m, fa._delta(do, out))
    kw = dict(sm_scale=0.3, p_dropout=p_dropout)
    before = (fa.flash_bwd_single.launches, _route_counts(fa.flash_bwd_dkv),
              _route_counts(fa.flash_bwd_dq))
    dq, dk, dv = fa.flash_bwd_single(*args, **kw)
    assert (fa.flash_bwd_single.launches, _route_counts(fa.flash_bwd_dkv),
            _route_counts(fa.flash_bwd_dq)) == (before[0] + 1, *before[1:])
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    want_dk, want_dv = fa.bwd_dkv_plain(*args, causal=False, **kw)
    want_dq = fa.bwd_dq_plain(*args, causal=False, **kw)
    _assert_close((dq, dk, dv), (want_dq, want_dk, want_dv), dtype)
    if qs is not None:
        assert (dq.transpose(1, 2)[qs < 0] == 0).all()
        assert (dk.transpose(1, 2)[ks < 0] == 0).all()
        assert (dv.transpose(1, 2)[ks < 0] == 0).all()
    if segments == "differ":          # the rows whose segment meets no key
        assert (l[0, :, :4] == 0).all() and (dq[0, :, :4] == 0).all()


def test_flash_bwd_single_reruns_bit_identical(cuda):
    """No atomics: a rerun gives the same dq, dk and dv bit for bit, and
    ``_bwd_dispatch`` takes the kernel for BST's heads (f32 D8, Skv 128)."""
    gen = torch.Generator().manual_seed(5)
    b, h, s, d = 64, 8, 128, 8
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(cuda)
                   for _ in range(4))
    qs, ks = _single_segments(gen, b, s, s, "bst", cuda)
    out, l, m = fa.flash_fwd_single(q, k, v, qs, ks, 2, sm_scale=0.35,
                                    p_dropout=0.2)
    args = (q, k, v, qs, ks, 2, do, l, m, fa._delta(do, out))
    before = fa.flash_bwd_single.launches
    got = fa._bwd_dispatch(*args, causal=False, sm_scale=0.35, p_dropout=0.2)
    assert fa.flash_bwd_single.launches == before + 1
    for _ in range(3):
        again = fa.flash_bwd_single(*args, sm_scale=0.35, p_dropout=0.2)
        assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_bwd_smem_bytes_mirrors_the_kernel(cuda, dtype):
    """The Python mirror of the kernel's shared-memory layout gives the
    kernel's own size at every padded D and at Skv 1-320."""
    lib = fa._flash_bwd_single_lib()
    code = fa._DTYPES[dtype]
    for d in range(8, 129, 8):
        for skv in (1, 7, 64, 65, 128, 200, 320):
            assert lib.tfp_flash_bwd_single_smem(d, skv, code) == \
                fa.single_bwd_smem_bytes(skv, d, dtype)


def test_flash_bwd_single_refuses_what_does_not_fit(cuda):
    big = torch.zeros(1, 1, 1024, 64, device=cuda)
    stats = torch.zeros(1, 1, 1024, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_bwd_single(big, big, big, None, None, 0, big, stats, stats,
                            stats, sm_scale=1.0)


@pytest.mark.parametrize("name", ["DCN", "BST"])
def test_training_step_on_the_card_matches_the_cpu(cuda, name):
    """Three training steps from one state on the card and on the CPU:
    headers (keys and meta) bit for bit; losses within 1e-5, payloads and
    dense parameters within atol 2e-5, rtol 1e-4 (the CPU parity tests'
    limits: Adam steps whose error follows the gradients')."""
    import functools

    from tfplus_tpu_torch import train
    if name == "DCN":
        model = models.DCN(embedding_dims=(8, 16, 8), num_numeric=4,
                           dnn_hidden=(32, 16), capacity=1024)
        opt = train.GroupAdamOptimizer()
    else:
        model = _small_sequence_model("BST")
        opt = train.AdamOptimizer()
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(3):
        if name == "DCN":
            batches.append({
                "ids": {f"C{i + 1}": rng.randint(0, 500, 64) for i in range(3)},
                "features": rng.randn(64, 4).astype(np.float32),
                "labels": rng.randint(0, 2, 64).astype(np.float32)})
        else:
            lengths = rng.randint(0, 8, 64)
            mask = (np.arange(7)[None, :] < lengths[:, None]).astype(
                np.float32)
            seq = np.where(mask > 0, rng.randint(1, 500, (64, 7)), 0)
            batches.append({
                "ids": {"item": model.pack_item_ids(rng.randint(1, 500, 64),
                                                    seq),
                        "user": rng.randint(1, 500, 64)},
                "features": {"numeric": rng.randn(64, 3).astype(np.float32),
                             "mask": mask},
                "labels": rng.randint(0, 2, 64).astype(np.float32)})
    out = {}
    for dev in ("cpu", cuda):
        state = models.init_state(model, opt,
                                  functools.partial(torch.optim.Adam, lr=1e-2),
                                  seed=2, device=dev)
        step = models.make_train_step(model, opt, sparse_lr=0.05)
        bwd = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
               fa.flash_bwd_single.launches)
        losses = []
        for b in batches:
            state, loss, _ = step(state, b)
            losses.append(float(loss))
        if dev != "cpu" and name == "BST":      # f32 D8 heads: single pass
            assert (fa.flash_bwd_dkv.launches - bwd[0],
                    fa.flash_bwd_dq.launches - bwd[1],
                    fa.flash_bwd_single.launches - bwd[2]) == (0, 0, 3)
        out[str(dev)] = (losses, {n: (t.header.cpu(), t.payload.cpu())
                                  for n, t in state.tables.items()},
                         [p.detach().cpu() for p in state.dense.parameters()])
    (lc, tc, pc), (lg, tg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, atol=1e-5, rtol=1e-5)
    for n in tc:
        assert torch.equal(tc[n][0], tg[n][0])
        np.testing.assert_allclose(tg[n][1].numpy(), tc[n][1].numpy(),
                                   atol=2e-5, rtol=1e-4)
    for a, b in zip(pc, pg):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5, rtol=1e-4)


def test_take_backward_is_deterministic_on_the_card(cuda):
    """The embedding take's backward on the card (sort-based ``index_put_``
    accumulate) reruns bit for bit with one id repeated 20,000 times, as
    BST's pad id is, and agrees with the CPU's within f32 summation
    order."""
    from tfplus_tpu_torch import embedding
    gen = torch.Generator().manual_seed(1)
    n, u, d = 60_000, 2_000, 64
    inverse = torch.randint(0, u, (n,), generator=gen, dtype=torch.int32)
    inverse[::3] = 0
    rows = torch.randn(u, d, generator=gen)
    grad = torch.randn(n, d, generator=gen)

    def rows_grad(device):
        look = embedding.Lookup(rows=None, slot=None,
                                inverse=inverse.to(device), counts=None,
                                valid=torch.ones(n, dtype=torch.bool,
                                                 device=device),
                                num_unique=None)
        leaf = rows.to(device).requires_grad_()
        (embedding.gather(look, leaf) * grad.to(device)).sum().backward()
        return leaf.grad.cpu()

    got = rows_grad(cuda)
    assert all(torch.equal(got, rows_grad(cuda)) for _ in range(3))
    np.testing.assert_allclose(got.numpy(), rows_grad("cpu").numpy(),
                               atol=1e-3, rtol=1e-5)


# ---------------------------------------------------------------------------
# compactor, growth and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,w,r,frac,out_rows,dtype", [
    (512, 128, 32, 0.0, None, torch.float32),
    (512, 128, 32, 0.3, None, torch.float32),
    (4096, 256, 128, 2 / 3, None, torch.float32),
    (4096, 128, 128, 0.97, None, torch.float32),
    (512, 128, 32, 1.0, None, torch.float32),
    (64, 128, 16, 0.5, None, torch.float32),
    (1000, 384, 1000, 0.5, None, torch.float32),      # one block, R > 256
    (512, 256, 32, 0.5, 640, torch.float32),          # out_rows > M
    (512, 256, 32, 0.5, 128, torch.float32),          # live rows dropped
    (2048, 128, 64, 0.6, None, torch.bfloat16),
    (2048, 128, 64, 0.6, None, torch.float16)])
def test_compactor_matches_plain(cuda, m, w, r, frac, out_rows, dtype):
    gen = torch.Generator().manual_seed(m + w)
    arena = torch.randn(m, w, generator=gen).to(dtype)
    live = torch.rand(m, generator=gen) < frac
    if m == 4096:                         # whole dead and live blocks too
        live[:512] = True
        live[1024:1536] = False
    want_p, want_l = compactor.compact_plain(arena, live, out_rows=out_rows)
    n = min(int(live.sum()), out_rows or m)
    before = compactor.compact.launches
    got_p, got_l = compactor.compact(arena.to(cuda), live.to(cuda),
                                     block_rows=r, out_rows=out_rows)
    again_p, again_l = compactor.compact(arena.to(cuda), live.to(cuda),
                                         block_rows=r, out_rows=out_rows)
    torch.cuda.synchronize()
    assert compactor.compact.launches == before + 2
    assert torch.equal(got_p[:n].cpu(), want_p[:n])
    assert torch.equal(got_l.cpu(), want_l)
    assert torch.equal(got_p[:n], again_p[:n]) and torch.equal(got_l,
                                                               again_l)


def test_compactor_refuses_what_the_kernel_does_not_take(cuda):
    arena = torch.zeros(64, 256, device=cuda)
    live = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        compactor.compact(arena[:, :128], live, block_rows=16)  # strided
    with pytest.raises(ValueError):
        compactor.compact(arena, live.cpu(), block_rows=16)
    with pytest.raises(TypeError):
        compactor.compact(arena.double(), live, block_rows=16)


def test_growth_and_checkpoint_on_the_card_match_the_cpu(cuda, tmp_path):
    """grow, grow_to_fit, compact, export and a full + delta checkpoint
    round trip on the card leave the tables the same calls leave on the
    CPU, bit for bit (rows and slot columns written with ``insert_raw``:
    pure data movement, no arithmetic that may round apart)."""
    from tfplus_tpu_torch import train
    from tfplus_tpu_torch.utils import packing
    rng = np.random.RandomState(4)
    opt = train.GroupAdamOptimizer(learning_rate=0.05)
    ids = np.unique(rng.randint(0, 1 << 40, 720).astype(np.int64))[:700]
    more = rng.randint(0, 1 << 40, 300).astype(np.int64)
    rows = torch.from_numpy(rng.randn(700, 64).astype(np.float32))
    meta = packing.pack(torch.from_numpy(rng.randint(1, 900, 700)), 3)
    out = {}
    for d in ("cpu", cuda):
        t = opt.init(kv.create(16, 1024, max_probes=8, init_pool_rows=100,
                               seed=5, device=d))
        kv.insert_raw(t, kv.encode_ids(ids, device=d), rows.to(d),
                      meta.to(d))
        t = kv.grow(t)
        t = kv.grow_to_fit(t, 5000)
        kv.delete(t, kv.encode_ids(ids[:400], device=d))
        t = kv.compact(t)
        mgr = checkpoint.CheckpointManager(str(tmp_path / str(d)))
        t = mgr.save({"t": t}, step=1, full=True)["t"]
        kv.lookup_or_insert(t, kv.encode_ids(more, device=d), day=4)
        t = mgr.save({"t": t}, step=2, full=False)["t"]
        template = opt.init(kv.create(16, 256, seed=1, device=d))
        restored, _, _ = mgr.restore({"t": template})
        ex = kv.export_arrays(restored["t"], as_of_unix_day=20000)
        out[d] = [t.header, t.payload, restored["t"].header,
                  restored["t"].payload] + [torch.from_numpy(
                      np.asarray(ex[k]).astype(np.float64))
                      for k in ("keys", "values", "meta")]
    for a, b in zip(out["cpu"], out[cuda]):
        assert torch.equal(a, b.cpu())


# ---------------------------------------------------------------------------
# serving API, int8 tables, table ops, sparse lookups, the CTR models
# ---------------------------------------------------------------------------

def _bits(t):
    """A tensor's exact bits (float32 viewed as int32), on the CPU."""
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("dim", [1, 3, 16])
def test_narrow_tables_on_the_card_match_the_cpu(cuda, dim):
    """Tables of dim 1 and 3 (DeepFM's and Wide&Deep's linear weights: 4-
    and 12-byte rows through the row kernels) and 16: inserts, lookups
    and a scatter leave the CPU's tables bit for bit."""
    rng = np.random.RandomState(20 + dim)
    ids = rng.randint(0, 1 << 40, 900).astype(np.int64)
    rows = torch.from_numpy(rng.randn(300, dim).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        t = kv.create(dim, 1024, init_pool_rows=50, seed=2, device=d)
        before = rowops.gather_rows.launches
        res = kv.lookup_or_insert(t, kv.encode_ids(ids[:600], device=d))
        kv.insert(t, kv.encode_ids(ids[600:], device=d), rows.to(d), day=3)
        kv.scatter(t, kv.encode_ids(ids[::4], device=d),
                   rows[:225].to(d) * 0.5, "add", day=4)
        got = kv.lookup_or_zeros(t, kv.encode_ids(ids + 1, device=d))
        if d != "cpu":
            assert rowops.gather_rows.launches > before
        out[str(d)] = [res.rows, got, t.header, t.payload]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(_bits(a), _bits(b))


def test_int8_tables_on_the_card_match_the_cpu(cuda):
    """quantize_table and the int8 lookup on the card: header (scales in the
    pad lanes), int8 payload and dequantized rows equal the CPU's bit for
    bit (IEEE division and products on both)."""
    from tfplus_tpu_torch.kv import quant
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 1 << 40, 2000).astype(np.int64)
    rows = rng.randn(2000, 64) * rng.choice([1e-3, 1.0, 50.0], (2000, 1))
    rows[:5] = 0.0
    out = {}
    for d in ("cpu", cuda):
        t = kv.create(64, 4096, init_pool_rows=100, seed=1, device=d)
        kv.insert(t, kv.encode_ids(ids, device=d),
                  torch.from_numpy(rows.astype(np.float32)).to(d), day=2,
                  blacklist=torch.from_numpy(np.arange(2000) % 9 == 0).to(d))
        qt = quant.quantize_table(t)
        q = kv.encode_ids(np.concatenate([ids, ids + 1]), device=d)
        out[str(d)] = [qt.header, qt.payload, qt.scale,
                       quant.lookup_or_zeros(qt, q)]
        if d != "cpu":
            assert quant.max_quant_error(t) <= float(
                np.abs(rows).max()) / 254 * (1 + 2 ** -20)
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("op", ["update", "add", "sub", "mul", "div", "min",
                                "max"])
def test_scatter_and_ttl_on_the_card_match_the_cpu(cuda, op):
    """A scatter op over ids half present, then get_count, get_timestamp
    and a TTL eviction: header, payload and deletion log bit for bit."""
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 1 << 40, 1000).astype(np.int64)
    q = np.concatenate([ids[:500], rng.randint(1 << 41, 1 << 42, 500)])
    upd = torch.from_numpy(rng.randn(1000, 32).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        t = kv.create(32, 4096, init_pool_rows=100, seed=1, device=d)
        kv.lookup_or_insert(t, kv.encode_ids(ids, device=d), day=10)
        before = rowops.scatter_rows.launches
        kv.scatter(t, kv.encode_ids(q, device=d), upd.to(d), op, day=20)
        if d != "cpu":
            assert rowops.scatter_rows.launches > before
        qq = kv.encode_ids(q, device=d)
        counts, days = kv.get_count(t, qq), kv.get_timestamp(t, qq)
        _, evicted = kv.delete_with_timestamp(t, 5, 20)
        out[str(d)] = [counts, days, evicted, t.header, t.payload,
                       t.deleted_keys, t.deleted_count]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(_bits(a), _bits(b))
    assert int(out["cpu"][2].sum()) == 500


def test_sparse_lookups_rerun_bit_identical_on_the_card(cuda):
    """safe_embedding_lookup_sparse on the card, each combiner weighted and
    not, with negative ids and a default id: two runs bit for bit (forward
    and the rows' gradient), within 1e-6 of the CPU's scale."""
    from tfplus_tpu_torch import embedding
    rng = np.random.RandomState(9)
    keys = rng.randint(1, 1 << 40, 3000).astype(np.int64)
    n, b = 20_000, 2048
    q = keys[rng.randint(0, 3000, n)]
    q[::17] = -q[::17]
    seg = np.sort(rng.randint(0, b, n)).astype(np.int32)
    w = rng.rand(n).astype(np.float32) - 0.1
    rows = torch.from_numpy(rng.randn(3000, 32).astype(np.float32))
    tables = {}
    for d in ("cpu", cuda):
        tables[str(d)] = t = kv.create(32, 8192, seed=3, device=d)
        kv.insert(t, kv.encode_ids(keys, device=d), rows.to(d), day=1)

    def run(d, combiner, weights):
        t = tables[str(d)]
        wt = None if weights is None else torch.from_numpy(weights).to(d)
        out, look, _ = embedding.safe_embedding_lookup_sparse(
            t, q, seg, b, weights=wt, combiner=combiner, train=False,
            default_id=int(keys[0]))
        rows = look.rows.detach().requires_grad_()
        embedding.combine(look, torch.from_numpy(seg).to(d), b, rows=rows,
                          weights=None if wt is None else wt.clamp(min=0),
                          combiner=combiner).sum().backward()
        return out, rows.grad

    for combiner in ("sum", "mean", "sqrtn"):
        for weights in (None, w):
            a, ga = run(cuda, combiner, weights)
            b2, gb = run(cuda, combiner, weights)
            assert torch.equal(_bits(a), _bits(b2))
            assert torch.equal(_bits(ga), _bits(gb))
            c, _ = run("cpu", combiner, weights)
            scale = float(c.abs().max())
            np.testing.assert_allclose(a.cpu().numpy(), c.numpy(),
                                       atol=1e-6 * scale, rtol=1e-6)


def test_serving_flow_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Export, template-free load (f32 and int8) and a delta refresh on the
    card give the tables the same calls give on the CPU, bit for bit."""
    from tfplus_tpu_torch import serving
    rng = np.random.RandomState(10)
    ids = rng.randint(1, 1 << 40, 700).astype(np.int64)
    rows = torch.from_numpy(rng.randn(700, 16).astype(np.float32))
    upd = np.concatenate([ids[:100], rng.randint(1 << 41, 1 << 42, 600)])
    upd_rows = torch.from_numpy(rng.randn(700, 16).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        t = kv.create(16, 2048, seed=1, device=d)
        kv.insert(t, kv.encode_ids(ids, device=d), rows.to(d), day=3)
        md = serving.RankingMetadata()
        md.add_embedding_column(column_name="u", var_name="emb",
                                embedding_dim=16)
        d_dir = str(tmp_path / f"srv_{d}")
        serving.export_for_serving(d_dir, {"emb": t}, md)
        f32, _ = serving.load_for_serving(d_dir, device=d)
        i8, _ = serving.load_for_serving(d_dir, quantize=True, device=d)
        kv.clear_deltalist(t)
        kv.insert(t, kv.encode_ids(upd, device=d), upd_rows.to(d), day=4)
        delta = str(tmp_path / f"delta_{d}")
        checkpoint.save(delta, {"emb": t}, delta=True)
        f32 = serving.refresh_from_delta(f32, delta)["emb"]
        i8 = serving.refresh_from_delta(i8, delta, quantize=True)["emb"]
        out[str(d)] = [f32.header, f32.payload, i8.header, i8.payload]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", ["DLRM", "DeepFM", "WideDeep", "NCF"])
def test_ctr_models_train_the_same_on_the_card(cuda, name):
    """Three training steps of each CTR model on the card and on the CPU:
    headers bit for bit, losses within 1e-5; payloads and dense parameters
    within atol 2e-5, rtol 1e-4 on all but 1e-3 of the elements and within
    one learning rate per step everywhere (``chip_smoke.py``'s
    ``TRAIN_TOL``): Adam's step ``lr·m̂/(√v̂ + ε)`` turns two summation
    orders of a gradient that nearly cancels into steps that differ by up
    to about ``lr`` (on the H100, 2 of DLRM's 24,576 payload elements lay
    past the tight limit, by 0.005 of a learning rate)."""
    import functools

    from tfplus_tpu_torch import train
    kw = {"DLRM": dict(num_tables=4, embedding_dim=8, bottom_hidden=(16, 8),
                       top_hidden=(16,), capacity=1024),
          "DeepFM": dict(num_fields=4, embedding_dim=8, dnn_hidden=(16, 8),
                         capacity=1024),
          "WideDeep": dict(num_fields=4, embedding_dim=8, dnn_hidden=(16, 8),
                           capacity=1024),
          "NCF": dict(embedding_dim=8, hidden=(16, 8), capacity=1024)}[name]
    model = getattr(models, name)(**kw)
    opt = train.AdamOptimizer()
    alias = getattr(model, "id_alias", {})
    streams = sorted({alias.get(n, n) for n in model.table_specs})
    rng = np.random.RandomState(11)
    batches = [{"ids": {s: rng.randint(1, 400, 128) for s in streams},
                "features": rng.randn(128, 13).astype(np.float32),
                "labels": rng.randint(0, 2, 128).astype(np.float32)}
               for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda):
        state = models.init_state(model, opt,
                                  functools.partial(torch.optim.Adam, lr=1e-2),
                                  seed=2, device=dev)
        step = models.make_train_step(model, opt, sparse_lr=0.05)
        losses = []
        for b in batches:
            state, loss, _ = step(state, b)
            losses.append(float(loss))
        out[str(dev)] = (losses, {n: (t.header.cpu(), t.payload.cpu())
                                  for n, t in state.tables.items()},
                         [p.detach().cpu() for p in state.dense.parameters()])
    (lc, tc, pc), (lg, tg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, atol=1e-5, rtol=1e-5)
    for n in tc:
        assert torch.equal(tc[n][0], tg[n][0])

    def assert_within(got, want, lr):
        over = total = 0
        for g, w in zip(got, want):
            d = (g.double() - w.double()).abs()
            over += int((d > 2e-5 + 1e-4 * w.double().abs()).sum())
            total += w.numel()
            assert float(d.max()) <= len(batches) * lr
        assert over <= 1e-3 * total

    assert_within([tg[n][1] for n in tc], [tc[n][1] for n in tc], 0.05)
    assert_within(pg, pc, 1e-2)
