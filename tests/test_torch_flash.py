"""Port parity for the flash-attention forward: the same numpy inputs go
through the JAX package's Pallas kernels in interpret mode and through the
port, whose kernel wrappers run their plain PyTorch versions on the CPU.

Tolerances: float32 with another summation order in qkᵀ, the row sums and
pv (and, for the tiled route, another tile width in the online softmax), so
``atol = rtol = 1e-5``; a flipped dropout bit moves an output by about
p·v/(1 − p_dropout), far above that. bfloat16 outputs round to 8 bits of
mantissa after the same f32 arithmetic, so they may differ by one bf16 ulp:
``atol = rtol = 1e-2``. The keep mask is compared bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu.ops import flash_attention as jfa
from tfplus_tpu_torch import nn as tnn
from tfplus_tpu_torch.ops import flash_attention as tfa

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


def _segments(b, s, seed):
    """Two segments per row, a padded tail (−1), one row all padding."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cut, end = sorted(rng.randint(1, s, 2))
        seg[i, cut:] = 1
        seg[i, max(end, cut + 1):] = -1
    seg[-1] = -1
    return seg


def _bst_segments(b, s, seed):
    """BST's layout: a history prefix of 1-20 tokens, the candidate at
    position 20, padding after it; the last batch row all padding."""
    lengths = np.random.RandomState(seed).randint(1, 21, b)
    seg = np.full((b, s), -1, np.int32)
    for i, n in enumerate(lengths[:-1]):
        seg[i, :n] = 0
        seg[i, 20] = 0
    return seg


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# (name, b, h, s, d, causal, segments, dtype, p_dropout); JAX's route in
# brackets: causal -> _fwd, non-causal -> _fwd_single; the port routes
# non-causal to its single-pass version only where the KV fits one block.
CASES = [
    ("causal_fwd", 1, 2, 256, 32, True, False, "f32", 0.0),
    ("noncausal_single", 2, 2, 128, 8, False, False, "f32", 0.0),
    ("noncausal_d32", 1, 2, 256, 32, False, False, "f32", 0.0),
    ("segments_padding", 3, 2, 128, 8, False, True, "f32", 0.0),
    ("causal_segments", 3, 1, 256, 32, True, True, "f32", 0.0),
    ("odd_length", 2, 2, 200, 32, False, True, "f32", 0.0),
    ("odd_length_causal", 1, 2, 200, 8, True, False, "f32", 0.0),
    ("bf16_causal", 1, 2, 256, 32, True, False, "bf16", 0.0),
    ("bf16_single", 2, 2, 128, 8, False, True, "bf16", 0.0),
    ("dropout_single", 2, 2, 128, 8, False, True, "f32", 0.3),
    ("dropout_causal_odd", 1, 2, 200, 32, True, False, "f32", 0.3),
    ("dropout_bf16", 1, 2, 256, 32, True, True, "bf16", 0.3),
    ("d12_segments", 2, 2, 128, 12, False, True, "f32", 0.0),
]


@pytest.mark.parametrize("name,b,h,s,d,causal,segments,dtype,p_dropout",
                         CASES, ids=[c[0] for c in CASES])
def test_forward_and_lse_match_the_pallas_kernels(name, b, h, s, d, causal,
                                                  segments, dtype, p_dropout):
    q, k, v = _inputs(b, h, s, s, d, seed=len(name))
    seg = _segments(b, s, seed=d) if segments else None
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(causal=causal, p_dropout=p_dropout, dropout_seed=-17)
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jout = jfa.flash_attention(jq, jk, jv, q_segment_ids=jseg,
                               kv_segment_ids=jseg, block_q=128, block_k=128,
                               interpret=True, **kw)
    jout2, jlse = jfa.flash_attention_with_lse(
        jq, jk, jv, q_segment_ids=jseg, kv_segment_ids=jseg, block_q=128,
        block_k=128, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tout = tfa.flash_attention(tq, tk, tv, q_segment_ids=seg,
                               kv_segment_ids=seg, **kw)
    tout2, tlse = tfa.flash_attention_with_lse(
        tq, tk, tv, q_segment_ids=seg, kv_segment_ids=seg, **kw)
    assert tout.dtype == tdt and tout.shape == (b, h, s, d)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    np.testing.assert_allclose(_f32(tout2), _f32(jout2), **tol)
    jlse, tlse = np.asarray(jlse), tlse.numpy()
    np.testing.assert_array_equal(np.isneginf(tlse), np.isneginf(jlse))
    hit = np.isfinite(jlse)
    np.testing.assert_allclose(tlse[hit], jlse[hit], **F32_TOL)
    if seg is not None:                  # padding rows: zeros and -inf
        pad = np.broadcast_to((seg < 0)[:, None, :], tlse.shape)
        assert np.isneginf(tlse[pad]).all()
        assert (_f32(tout)[pad] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_residuals_match_the_pallas_kernels(causal):
    """l (pre-dropout sum, 0 on never-hit rows) and m (row max, about
    mask_value on never-hit rows) of the JAX kernel, from the port's
    wrappers with the route the JAX package takes."""
    b, h, s, d = 2, 2, 256, 16
    q, k, v = _inputs(b, h, s, s, d, seed=5)
    seg = _segments(b, s, seed=6)
    seed = np.asarray([3], np.int32)
    _, jl, jm = jfa._fwd_dispatch(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), jnp.asarray(seed), causal, 0.25, 128, 128, True,
        save_residuals=True, p_dropout=0.2)
    wrapper = tfa.flash_fwd if causal else tfa.flash_fwd_single
    kw = dict(causal=True) if causal else {}
    tseg = torch.from_numpy(seg)
    _, tl, tm = wrapper(*(torch.from_numpy(x) for x in (q, k, v)), tseg, tseg,
                        3, sm_scale=0.25, p_dropout=0.2, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **F32_TOL)
    never = np.broadcast_to((seg < 0)[:, None, :], tl.shape)
    assert (tl.numpy()[never] == 0).all()
    assert (tm.numpy()[never] <= 0.5 * tfa.DEFAULT_MASK_VALUE).all()


@pytest.mark.parametrize("seed,row0,col0,p", [
    (0, 0, 0, 0.3), (-5, 5, 100, 0.3), (2**31 - 1, 0, 4096, 0.9),
    (7, 1000, 3, 1e-6)])
def test_dropout_keep_mask_is_bit_identical(seed, row0, col0, p):
    want = np.asarray(jfa._dropout_keep_dense(jnp.int32(seed), 2, 3, 17, 33,
                                              p, row0=row0, col0=col0))
    got = tfa._dropout_keep_dense(seed, 2, 3, 17, 33, p, row0=row0,
                                  col0=col0).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_versions_agree_with_each_other_and_the_reference():
    """Both plain kernels and the exact reference compute one function."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 130, 130, 24, 9))
    seg = torch.from_numpy(_segments(2, 130, seed=1))
    single = tfa.fwd_single_plain(q, k, v, seg, seg, 4, sm_scale=0.3,
                                  p_dropout=0.25)
    tiled = tfa.fwd_tiled_plain(q, k, v, seg, seg, 4, causal=False,
                                sm_scale=0.3, p_dropout=0.25)
    ref = tfa.reference_attention(q, k, v, sm_scale=0.3, q_segment_ids=seg,
                                  kv_segment_ids=seg, p_dropout=0.25,
                                  dropout_seed=4)
    for a, b in zip(single, tiled):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)
    np.testing.assert_allclose(single[0].numpy(), ref.numpy(), **F32_TOL)


def test_dispatch_routes_as_on_the_card(monkeypatch):
    calls = []
    for name in ("fwd_single_plain", "fwd_tiled_plain"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    launches = (tfa.flash_fwd.launches, tfa.flash_fwd_single.launches)

    def run(s, d, causal, dtype=torch.float32):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(1, 1, s, s, d, 0))
        tfa.flash_attention(q, k, v, causal=causal)
        return calls.pop()

    assert tfa.single_fits(128, 8, torch.float32)       # BST's heads
    assert run(128, 8, False) == "fwd_single_plain"
    assert run(128, 8, True) == "fwd_tiled_plain"
    assert not tfa.single_fits(1024, 64, torch.float32)
    assert run(1024, 64, False) == "fwd_tiled_plain"
    # the single-pass kernel holds a padded D of at most 128
    assert tfa.single_fits(64, 128, torch.bfloat16)
    assert not tfa.single_fits(64, 130, torch.bfloat16)
    assert run(64, 130, False) == "fwd_tiled_plain"
    # bf16 at a padded D of 64/128 keeps the tensor-core route of the tiled
    # kernel though the KV fits; other widths, and f32, take the single pass
    assert run(64, 128, False, torch.bfloat16) == "fwd_tiled_plain"
    assert run(192, 64, False, torch.bfloat16) == "fwd_tiled_plain"
    assert run(64, 60, False, torch.bfloat16) == "fwd_tiled_plain"
    assert run(200, 16, False, torch.bfloat16) == "fwd_single_plain"
    assert run(64, 64, False) == "fwd_single_plain"
    # CPU calls run the plain versions and launch nothing
    assert (tfa.flash_fwd.launches, tfa.flash_fwd_single.launches) \
        == launches


def test_layer_matches_the_jax_layer():
    """[B, S, H, D] layout; padding from a mask or from lengths."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(3, 40, 2, 8).astype(np.float32) for _ in range(3))
    lengths = np.array([40, 17, 0])
    mask = (np.arange(40)[None, :] < lengths[:, None]).astype(np.float32)
    from tfplus_tpu.nn.attention import flash_attention_layer as jlayer
    for kw in (dict(attention_mask=mask), dict(lengths=lengths), {}):
        want = jlayer(*(jnp.asarray(x) for x in (q, k, v)), interpret=True,
                      **{n: jnp.asarray(x) for n, x in kw.items()})
        got = tnn.flash_attention_layer(*(torch.from_numpy(x)
                                          for x in (q, k, v)), **kw)
        assert got.shape == (3, 40, 2, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# (name, b, h, s, d, causal, segments, dtype, p_dropout), segments True
# (_segments) or "bst" (_bst_segments); JAX's gradient runs _flash_bwd ->
# _bwd_pallas in interpret mode (the dkv and dq kernels)
GRAD_CASES = [
    ("causal", 1, 2, 256, 32, True, False, "f32", 0.0),
    ("noncausal_d8", 2, 2, 128, 8, False, False, "f32", 0.0),
    ("segments_padding", 3, 2, 128, 8, False, True, "f32", 0.0),
    ("odd_causal_segments", 2, 1, 200, 32, True, True, "f32", 0.0),
    ("odd_noncausal", 1, 2, 200, 8, False, False, "f32", 0.0),
    ("bf16_causal", 1, 2, 256, 32, True, False, "bf16", 0.0),
    ("bf16_segments", 2, 2, 128, 8, False, True, "bf16", 0.0),
    ("dropout_segments", 2, 2, 128, 8, False, True, "f32", 0.3),
    ("dropout_causal_odd", 1, 2, 200, 32, True, False, "f32", 0.3),
    ("d12_causal", 2, 2, 128, 12, True, False, "f32", 0.0),
    ("bst_dropout", 2, 2, 128, 8, False, "bst", "f32", 0.3),
]
# Gradients sum over up to S rows or keys in another order: f32 within
# atol = rtol = 1e-5 (they agree to about 6e-7 here). bf16: p_d and ds round
# to bf16 before their products on both sides, and an intermediate that
# lands on the other side of a rounding boundary moves a gradient by a bf16
# ulp of one term: atol = rtol = 1e-2, as for the bf16 outputs.
GRAD_TOL = {"f32": F32_TOL, "bf16": BF16_TOL}


@pytest.mark.parametrize("name,b,h,s,d,causal,segments,dtype,p_dropout",
                         GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_the_pallas_backward(name, b, h, s, d, causal,
                                             segments, dtype, p_dropout):
    q, k, v = _inputs(b, h, s, s, d, seed=len(name) + 3)
    do = np.random.RandomState(d).randn(b, h, s, d).astype(np.float32)
    seg = (_bst_segments(b, s, seed=s) if segments == "bst" else
           _segments(b, s, seed=s) if segments else None)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(causal=causal, p_dropout=p_dropout, dropout_seed=9)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, q_segment_ids=jseg,
                                  kv_segment_ids=jseg, block_q=128,
                                  block_k=128, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * do)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, q_segment_ids=seg,
                              kv_segment_ids=seg, **kw)
    (out.float() * torch.from_numpy(do)).sum().backward()
    for name_, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
        np.testing.assert_allclose(_f32(t.grad), _f32(j), err_msg=name_,
                                   **GRAD_TOL[dtype])
    if seg is not None:            # padding rows and keys get no gradient
        pad = np.broadcast_to((seg < 0)[:, None, :, None], (b, h, s, d))
        for t in (tq, tk, tv):
            assert (_f32(t.grad)[pad] == 0).all()


@pytest.mark.parametrize("causal,p_dropout", [(False, 0.0), (True, 0.0),
                                              (False, 0.25), (True, 0.25)])
def test_bwd_plain_matches_the_dense_recompute(causal, p_dropout):
    """From one set of residuals: the port's tile-by-tile plain backward
    against the JAX package's dense XLA recompute (``_flash_bwd`` off the
    TPU without interpret)."""
    b, h, s, d = 2, 2, 256, 16
    q, k, v = _inputs(b, h, s, s, d, seed=11)
    do = np.random.RandomState(12).randn(b, h, s, d).astype(np.float32)
    seg = _segments(b, s, seed=13)
    seed = np.asarray([21], np.int32)
    jq, jk, jv, jseg = (jnp.asarray(x) for x in (q, k, v, seg))
    out, l, m = jfa._fwd_dispatch(jq, jk, jv, jseg, jseg, jnp.asarray(seed),
                                  causal, 0.3, 128, 128, True,
                                  save_residuals=True, p_dropout=p_dropout)
    res = (jq, jk, jv, jseg, jseg, jnp.asarray(seed), out, l, m)
    want = jfa._flash_bwd(causal, 0.3, 128, 128, False, p_dropout, None, res,
                          jnp.asarray(do))[:3]
    tseg = torch.from_numpy(seg)
    got = tfa.bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), tseg,
                        tseg, 21, *(torch.from_numpy(np.array(x))
                                    for x in (out, l, m)),
                        torch.from_numpy(do), causal=causal, sm_scale=0.3,
                        p_dropout=p_dropout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **GRAD_TOL["f32"])


def test_gradients_are_a_later_slice():
    """``flash_attention_with_lse`` stays primal-only, as in JAX, while
    ``flash_attention`` is differentiable."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 8, 8, 8, 0))
    with pytest.raises(NotImplementedError, match="primal-only"):
        tfa.flash_attention_with_lse(q.requires_grad_(), k, v)
    with torch.no_grad():
        out, lse = tfa.flash_attention_with_lse(q, k, v)
        assert out.shape == (1, 1, 8, 8) and lse.shape == (1, 1, 8)
    out = tfa.flash_attention(q, k, v)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="both or neither"):
        tfa.flash_attention(q.detach(), k, v,
                            q_segment_ids=np.zeros((1, 8), np.int32))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 8, "cuda_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 96, "cuda_core"), (torch.float32, 8, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.bfloat16, 60, "tc"), (torch.bfloat16, 121, "tc"),
    (torch.bfloat16, 12, "cuda_core"), (torch.bfloat16, 136, "cuda_core"),
    (torch.float32, 60, "cuda_core")])
def test_route_is_chosen_from_dtype_and_head_dim(dtype, d, route):
    """bf16 at a padded D of 64 or 128 (D 57-64 or 121-128) takes the
    tensor-core kernels; f32 (whose only tensor-core input is TF32) and the
    other bf16 widths keep the CUDA-core ones. Nothing but dtype and D
    decides, so the decision is the same for every shape, causal or not,
    and for each of the three routed wrappers (the forward, dk/dv and dq),
    which count their launches per route."""
    assert tfa.flash_route(dtype, d) == route
    for fn in (tfa.flash_fwd, tfa.flash_bwd_dkv, tfa.flash_bwd_dq):
        assert isinstance(getattr(fn, f"{route}_launches"), int)


def test_cpu_calls_count_no_route():
    """A CPU tensor runs the plain version: neither route counts a launch."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 1, 70, 70, 64, 3))
    routed = (tfa.flash_fwd, tfa.flash_bwd_dkv, tfa.flash_bwd_dq)
    before = [(f.launches, f.tc_launches, f.cuda_core_launches)
              for f in routed]
    out, l, m = tfa.flash_fwd(q, k, v, None, None, 0, causal=True,
                              sm_scale=0.125)
    args = (q, k, v, None, None, 0, q, l, m, tfa._delta(q, out))
    tfa.flash_bwd_dkv(*args, causal=True, sm_scale=0.125)
    tfa.flash_bwd_dq(*args, causal=True, sm_scale=0.125)
    assert [(f.launches, f.tc_launches, f.cuda_core_launches)
            for f in routed] == before


@pytest.mark.parametrize("d,fwd,dkv,dq", [(64, 42496, 52224, 50688),
                                          (128, 83456, 101376, 99840)])
def test_tensor_core_shared_memory(d, fwd, dkv, dq):
    """The Python mirrors of the tensor-core kernels' ``Layout`` structs.
    Forward: Q plus two stages of K and V (five 64-row bf16 tiles), two
    stages of 64 key segment ids and 1 KB of alignment slack; dk/dv: K, V
    and two stages of Q and dO (six tiles), two stages of the q tile's l,
    m, di and segment ids, and the slack; dq: Q, dO and two stages of K and
    V (six tiles), two stages of 64 key segment ids, and the slack. Each
    fits twice on an SM (228 KB, 1 KB reserved per block), so two blocks
    share one."""
    assert tfa.tc_fwd_smem_bytes(d) == fwd
    assert tfa.tc_dkv_smem_bytes(d) == dkv
    assert tfa.tc_dq_smem_bytes(d) == dq
    for n in (fwd, dkv, dq):
        assert n <= tfa.SMEM_PER_BLOCK and 2 * (n + 1024) <= 228 * 1024


@pytest.mark.parametrize("d", [12, 20])
def test_padding_the_head_dim_is_exact(d):
    """What the wrappers do on the card at a D that is not a multiple of 8:
    the plain versions on the zero-padded q, k, v (and do) give, in the
    first D columns, what they give at the unpadded D, zeros in the padded
    columns, and the same l and m. Zero columns add exact zeros to q·kᵀ and
    do·vᵀ, but they may change how the CPU's matmul blocks its sums, so
    the comparison is within ``atol = rtol = 1e-5`` (f32)."""
    b, h, s = 2, 2, 70
    dp = tfa.padded_head_dim(d)
    assert dp == 8 * (d // 8 + 1)
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, s, s, d, seed=d))
    do = torch.from_numpy(np.random.RandomState(d + 1).randn(b, h, s, d)
                          .astype(np.float32))
    seg = torch.from_numpy(_segments(b, s, seed=d + 2))
    padded = tfa.pad_head_dim(q, k, v, do)
    assert all(t.shape == (b, h, s, dp) and (t[..., d:] == 0).all()
               for t in padded)
    assert tfa.pad_head_dim(padded[0])[0] is padded[0]     # already aligned

    def check(got, want):
        for g, w in zip(got, want):
            if g.dim() == 4:
                assert g.shape[-1] == dp and (g[..., d:] == 0).all()
                g = g[..., :d]
            np.testing.assert_allclose(g.numpy(), w.numpy(), **F32_TOL)

    kw = dict(sm_scale=0.3, p_dropout=0.25)
    fwd = tfa.fwd_tiled_plain(q, k, v, seg, seg, 4, causal=True, **kw)
    check(tfa.fwd_tiled_plain(*padded[:3], seg, seg, 4, causal=True, **kw),
          fwd)
    check(tfa.fwd_single_plain(*padded[:3], seg, seg, 4, **kw),
          tfa.fwd_single_plain(q, k, v, seg, seg, 4, **kw))
    out, l, m = fwd
    di = tfa._delta(do, out)
    kw["causal"] = True
    check(tfa.bwd_dkv_plain(*padded[:3], seg, seg, 4, padded[3], l, m, di,
                            **kw),
          tfa.bwd_dkv_plain(q, k, v, seg, seg, 4, do, l, m, di, **kw))
    check([tfa.bwd_dq_plain(*padded[:3], seg, seg, 4, padded[3], l, m, di,
                            **kw)],
          [tfa.bwd_dq_plain(q, k, v, seg, seg, 4, do, l, m, di, **kw)])


# (dtype, D, causal, Skv, route): _bwd_dispatch's rule, as on the card
BWD_ROUTES = [
    (torch.float32, 8, False, 128, "single"),       # BST's heads
    (torch.float32, 8, True, 128, "pair"),          # causal: dk/dv and dq
    (torch.float32, 8, False, 320, "single"),       # the largest KV at D 8
    (torch.float32, 8, False, 321, "pair"),         # past single_fits
    (torch.float32, 12, False, 130, "single"),      # padded to 16
    (torch.float32, 32, False, 128, "single"),
    (torch.float32, 64, False, 1000, "pair"),
    (torch.float32, 130, False, 16, "pair"),        # padded D above 128
    (torch.bfloat16, 16, False, 200, "single"),
    (torch.bfloat16, 64, False, 128, "pair"),       # fits, but tensor cores
    (torch.bfloat16, 128, False, 64, "pair"),
    (torch.bfloat16, 60, False, 64, "pair"),        # padded to 64
]


@pytest.mark.parametrize("dtype,d,causal,skv,route", BWD_ROUTES)
def test_backward_routes_as_on_the_card(monkeypatch, dtype, d, causal, skv,
                                        route):
    """``_bwd_dispatch`` takes ``flash_bwd_single`` where the forward took
    the single pass (not causal, ``single_fits``) and the CUDA cores serve
    the dtype and D (``flash_route``), else ``flash_bwd_dkv`` and
    ``flash_bwd_dq``; nothing but dtype, D, causal and Skv decides."""
    calls = []
    for name, outs in (("flash_bwd_single", 3), ("flash_bwd_dkv", 2),
                       ("flash_bwd_dq", 1)):
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _o=outs, **kw:
                            calls.append(_n) or (None,) * _o)
    q = torch.zeros(1, 1, 4, d, dtype=dtype)
    k = torch.zeros(1, 1, skv, d, dtype=dtype)
    stats = torch.zeros(1, 1, 4)
    tfa._bwd_dispatch(q, k, k, None, None, 0, q, stats, stats, stats,
                      causal=causal, sm_scale=0.3, p_dropout=0.0)
    assert calls == (["flash_bwd_single"] if route == "single"
                     else ["flash_bwd_dkv", "flash_bwd_dq"])
    single = not causal and tfa.single_fits(skv, d, dtype)
    assert (route == "single") == (single and tfa.flash_route(dtype, d)
                                   == "cuda_core")


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_backward_takes_the_single_pass_where_the_rule_says(monkeypatch,
                                                                causal):
    """``flash_attention``'s backward on the CPU: BST's heads (f32 D8,
    Skv 128, its segments, dropout) go through ``flash_bwd_single``, which
    returns the plain dk/dv and dq versions' results bit for bit; causal
    goes through ``flash_bwd_dkv`` and ``flash_bwd_dq`` instead."""
    calls = []
    real = tfa.flash_bwd_single
    monkeypatch.setattr(tfa, "flash_bwd_single", lambda *a, **kw:
                        calls.append(1) or real(*a, **kw))
    b, h, s, d = 3, 2, 128, 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, s, s, d, seed=4))
    do = torch.from_numpy(np.random.RandomState(5).randn(b, h, s, d)
                          .astype(np.float32))
    seg = torch.from_numpy(_bst_segments(b, s, seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = real.launches
    out = tfa.flash_attention(*leaves, causal=causal, q_segment_ids=seg,
                              kv_segment_ids=seg, p_dropout=0.3,
                              dropout_seed=7)
    got = torch.autograd.grad(out, leaves, do)
    assert calls == ([] if causal else [1])
    assert real.launches == before           # the CPU launches nothing
    fwd = tfa.fwd_tiled_plain if causal else tfa.fwd_single_plain
    kw = dict(sm_scale=d ** -0.5, p_dropout=0.3)
    o, l, m = fwd(q, k, v, seg, seg, 7, **kw,
                  **(dict(causal=True) if causal else {}))
    args = (q, k, v, seg, seg, 7, do, l, m, tfa._delta(do, o))
    want_dk, want_dv = tfa.bwd_dkv_plain(*args, causal=causal, **kw)
    want_dq = tfa.bwd_dq_plain(*args, causal=causal, **kw)
    for g, w in zip(got, (want_dq, want_dk, want_dv)):
        assert torch.equal(g, w)
    if not causal:
        assert all(torch.equal(g, w) for g, w in zip(
            real(*args, **kw), (want_dq, want_dk, want_dv)))


def test_single_backward_fits_wherever_the_single_pass_does():
    """``single_bwd_smem_bytes`` (the single-pass backward kernel's layout:
    K, V and f32 dk, dv accumulators for the whole KV, 32-row chunks of Q,
    dO and f32 dq, 32 × 33 f32 p_d and ds tiles, and the index lists) fits
    one block at every Skv and head dim that ``single_fits`` admits, f32
    and bf16, so ``_bwd_dispatch`` needs no fit rule of its own. BST's
    heads take 36,240 bytes, six blocks to an SM."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, 137):
            skv = 1
            while tfa.single_fits(skv, d, dtype):
                assert tfa.single_bwd_smem_bytes(skv, d, dtype) <= \
                    tfa.SMEM_PER_BLOCK, (dtype, d, skv)
                skv += 1
    assert tfa.single_bwd_smem_bytes(128, 8, torch.float32) == 36240


def _pad_rows_and_keys(x, seg, scale, seed):
    """``x`` [B, H, S, D] with the rows at padding positions (seg < 0)
    overwritten by randn·scale."""
    noise = torch.from_numpy(np.random.RandomState(seed).randn(*x.shape)
                             .astype(np.float32)) * scale
    pad = (seg < 0)[:, None, :, None]
    return torch.where(pad, noise, x)


@pytest.mark.parametrize("p_dropout", [0.0, 0.3])
def test_single_pass_skip_of_padding_is_exact(p_dropout):
    """What the single-pass kernel relies on to skip padding, on its plain
    version (BST's layout, f32): the q, k and v of padding rows and keys
    change no bit of out, l or m on the other rows, and a padding row gives
    out 0, l 0 and m = mask_value exactly, whatever its q, k and v."""
    b, h, s, d = 3, 2, 128, 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, s, s, d, seed=8))
    seg = torch.from_numpy(_bst_segments(b, s, seed=9))
    kw = dict(sm_scale=d ** -0.5, p_dropout=p_dropout)
    want = tfa.fwd_single_plain(q, k, v, seg, seg, 5, **kw)
    noisy = [_pad_rows_and_keys(x, seg, 100.0, i) for i, x in
             enumerate((q, k, v))]
    got = tfa.fwd_single_plain(*noisy, seg, seg, 5, **kw)
    valid = (seg >= 0)[:, None, :].expand(b, h, s)
    for g, w in zip(got, want):
        assert torch.equal(g[valid], w[valid])
    out, l, m = got
    assert (out[~valid] == 0).all() and (l[~valid] == 0).all()
    assert (m[~valid] == torch.tensor(tfa.DEFAULT_MASK_VALUE)).all()


def test_single_pass_rows_that_meet_no_key():
    """The edges of the skip, on the plain version: a batch row whose keys
    are all padding, and a q segment that no key carries. Their rows give
    out 0, l 0 and m = mask_value exactly; the other rows are those of a
    run in which the unmatched rows are padding."""
    b, h, s, d = 3, 2, 64, 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, h, s, s, d, seed=10))
    kv_seg = torch.from_numpy(_bst_segments(b, s, seed=11))
    kv_seg[0] = -1                               # batch row 0: no key
    q_seg = kv_seg.clone()
    q_seg[0, :5] = 0
    q_seg[1, 30:34] = 2                          # segment 2: no key
    kw = dict(sm_scale=0.3, p_dropout=0.2)
    out, l, m = tfa.fwd_single_plain(q, k, v, q_seg, kv_seg, 3, **kw)
    lone = torch.zeros_like(q_seg, dtype=torch.bool)
    lone[0, :5] = True
    lone[1, 30:34] = True
    lone = lone[:, None, :].expand(b, h, s)
    assert (out[lone] == 0).all() and (l[lone] == 0).all()
    assert (m[lone] == torch.tensor(tfa.DEFAULT_MASK_VALUE)).all()
    ref = tfa.fwd_single_plain(q, k, v, torch.where(lone[:, 0], -1, q_seg),
                               kv_seg, 3, **kw)
    for g, w in zip((out, l, m), ref):
        assert torch.equal(g, w)


def test_single_forward_fits_wherever_the_single_pass_does():
    """``single_fwd_smem_bytes`` (the single-pass forward kernel's layout:
    Q of 128 rows, K and V of Skv rounded up to 64 rows, the f32 score tile
    of ``single_fwd_tile`` rows by those keys, and the index lists) fits
    one block at every Skv and head dim that ``single_fits`` admits, f32
    and bf16, with segments and without, at the most rows a block takes;
    so ``_fwd_dispatch`` needs no fit rule of its own. BST's heads take
    35,856 bytes."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in range(1, 137):
            skv = 1
            while tfa.single_fits(skv, d, dtype):
                for seg in (False, True):
                    assert tfa.single_fwd_smem_bytes(
                        skv, d, dtype, segments=seg) <= tfa.SMEM_PER_BLOCK, (
                            dtype, d, skv, seg)
                skv += 1
    assert tfa.single_fwd_smem_bytes(128, 8, torch.float32) == 35856


@pytest.mark.parametrize("b,h,sq,rows,heads", [
    (2048, 8, 128, 128, 8),        # BST's heads: all eight heads per block
    (16, 8, 1000, 64, 1),          # few long problems: 64-row chunks
    (64, 8, 200, 64, 1), (4, 8, 128, 128, 1), (512, 8, 128, 128, 2),
    (1500, 4, 20, 64, 4), (64, 8, 64, 64, 1)])
def test_single_forward_block_shape_follows_the_shapes(b, h, sq, rows, heads):
    """Rows and heads per block come from B, H and Sq alone (no look at the
    data): 128 rows for Sq of 65-128, else 64; a block takes up to 8 heads
    while the grid keeps at least eight blocks per SM."""
    assert tfa.single_fwd_config(b, h, sq) == (rows, heads)
