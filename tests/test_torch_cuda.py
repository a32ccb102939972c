"""The port's CUDA kernels on the card.

Each row kernel is held bit for bit against its plain PyTorch version (these
are copies and single adds), including the narrow-word paths for odd widths
and misaligned rows, and the table engine's serving calls on the card leave
the same header and payload as the same calls on the CPU. Each flash-forward
kernel is held against its plain version at odd lengths, head dims 8/64/128,
f32 and bf16, causal, segments and dropout: f32 within ``atol = rtol =
1e-5`` (another summation order; one flipped dropout bit moves an output by
~1e-3), bf16 within ``1e-2`` (one bf16 ulp of the output). BST and DIN
served on the card give the CPU's predictions within ``1e-5``. The flash
backward kernels are held against their plain versions (same limits) and
float64 autograd, run deterministically, and a CUDA backward never reaches
a plain version; a few DCN and BST training steps on the card match the
same steps on the CPU. The compactor kernel matches its plain version bit
for bit, and table growth, compaction, export and a checkpoint round trip
on the card leave the same tables as on the CPU. Marked
``cuda``: every test skips without a card. On a machine with a card and
without JAX, run

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width", [1, 3, 64, 129, 384])
def test_gather_matches_plain(cuda, dtype, width):
    gen = torch.Generator().manual_seed(width)
    c, n = 4099, 5000
    values = _values(gen, c, width, dtype, cuda)
    idx = torch.randint(-7, c + 7, (n,), generator=gen, dtype=torch.int32)
    idx = idx.to(cuda)
    before = rowops.gather_rows.launches
    got = rowops.gather_rows(values, idx)
    assert rowops.gather_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, rowops.gather_rows_plain(values, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width", [1, 3, 64, 129, 384])
@pytest.mark.parametrize("add", [False, True])
def test_scatter_matches_plain(cuda, dtype, width, add):
    gen = torch.Generator().manual_seed(1000 + width)
    c, n = 4099, 3000
    values = _values(gen, c, width, dtype, cuda)
    rows = _values(gen, n, width, dtype, cuda)
    idx = torch.randperm(c + 40, generator=gen)[:n].to(torch.int32) - 20
    idx = idx.to(cuda)
    want = rowops.scatter_rows_plain(values.clone(), idx, rows, add)
    before = rowops.scatter_rows.launches
    got = rowops.scatter_rows(values, idx, rows, add=add)
    assert got is values and rowops.scatter_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("causal,segments,p_dropout", [
    (False, False, 0.0), (True, False, 0.0), (False, True, 0.0),
    (True, True, 0.2), (False, True, 0.2)])
def test_flash_fwd_matches_plain(cuda, dtype, d, causal, segments, p_dropout):
    b, h, sq, skv = 2, 3, 333, 275 if causal else 400
    q, k, v, qs, ks = _attention_inputs(d, b, h, sq, skv, d, dtype, cuda,
                                        segments)
    before = fa.flash_fwd.launches
    got = fa.flash_fwd(q, k, v, qs, ks, 11, causal=causal, sm_scale=0.2,
                       p_dropout=p_dropout)
    assert fa.flash_fwd.launches == before + 1
    torch.cuda.synchronize()
    want = fa.fwd_tiled_plain(q, k, v, qs, ks, 11, causal=causal,
                              sm_scale=0.2, p_dropout=p_dropout)
    _assert_close(got, want, dtype)
    out, l_, m_ = fa.flash_fwd(q, k, v, qs, ks, 11, causal=causal,
                               sm_scale=0.2, p_dropout=p_dropout,
                               save_residuals=False)
    assert l_ is None and m_ is None
    assert torch.equal(out, got[0])


@pytest.mark.parametrize("dtype,d,s", [
    (torch.float32, 8, 200), (torch.bfloat16, 8, 200),
    (torch.float32, 8, 128), (torch.float32, 64, 60),
    (torch.bfloat16, 64, 100), (torch.bfloat16, 128, 40)])
@pytest.mark.parametrize("segments,p_dropout", [
    (False, 0.0), (True, 0.0), (True, 0.2)])
def test_flash_fwd_single_matches_plain(cuda, dtype, d, s, segments,
                                        p_dropout):
    assert fa.single_fits(s, d, dtype)
    q, k, v, qs, ks = _attention_inputs(s + d, 3, 2, s, s, d, dtype, cuda,
                                        segments)
    before = fa.flash_fwd_single.launches
    got = fa.flash_fwd_single(q, k, v, qs, ks, -3, sm_scale=0.3,
                              p_dropout=p_dropout)
    assert fa.flash_fwd_single.launches == before + 1
    torch.cuda.synchronize()
    want = fa.fwd_single_plain(q, k, v, qs, ks, -3, sm_scale=0.3,
                               p_dropout=p_dropout)
    _assert_close(got, want, dtype)
    # the tiled kernel computes the same function
    _assert_close(got, fa.flash_fwd(q, k, v, qs, ks, -3, causal=False,
                                    sm_scale=0.3, p_dropout=p_dropout),
                  dtype)


def test_cuda_calls_never_run_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(fa, "fwd_single_plain", refuse)
    monkeypatch.setattr(fa, "fwd_tiled_plain", refuse)
    q, k, v, _, _ = _attention_inputs(0, 2, 8, 150, 150, 8, torch.float32,
                                      cuda, False)
    launches = fa.flash_fwd.launches, fa.flash_fwd_single.launches
    fa.flash_attention(q, k, v)                              # single
    fa.flash_attention(q, k, v, causal=True)                 # tiled
    out, lse = fa.flash_attention_with_lse(q, k, v, p_dropout=0.1)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd_single.launches) == (
        launches[0] + 1, launches[1] + 2)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 1, 16, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd(q, q, q, None, None, 0, causal=False, sm_scale=1.0)
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
def test_flash_bwd_matches_plain(cuda, dtype, d, causal, segments, p_dropout):
    """Both backward kernels at odd lengths against their plain versions:
    f32 within 1e-5 (another summation order; one flipped dropout bit moves
    a gradient by ~1e-2), bf16 within 1e-2 (an intermediate that rounds the
    other way moves a gradient by a bf16 ulp of one term)."""
    b, h, sq, skv = 2, 3, 333, 275 if causal else 400
    q, k, v, qs, ks, do, l, m, di, _ = _backward_inputs(
        d + 100, b, h, sq, skv, d, dtype, cuda, segments, causal, p_dropout)
    kw = dict(causal=causal, sm_scale=0.2, p_dropout=p_dropout)
    before = fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    dq = fa.flash_bwd_dq(q, k, v, qs, ks, 5, do, l, m, di, **kw)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
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
    launches = fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
    for causal in (False, True):
        q, k, v, _, _ = _attention_inputs(0, 2, 8, 150, 150, 8,
                                          torch.float32, cuda, False)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, causal=causal).sum().backward()
        assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (
        launches[0] + 2, launches[1] + 2)


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
        bwd = fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
        losses = []
        for b in batches:
            state, loss, _ = step(state, b)
            losses.append(float(loss))
        if dev != "cpu" and name == "BST":
            assert (fa.flash_bwd_dkv.launches - bwd[0],
                    fa.flash_bwd_dq.launches - bwd[1]) == (3, 3)
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
