"""Flash attention forward and backward, with segment-id varlen masking and
dropout.

Counterpart of ``tfplus_tpu/ops/flash_attention.py``.
Shapes: q ``[B, H, Sq, D]``, k/v ``[B, H, Skv, D]``, float32 or bfloat16;
optional int32 segment ids ``[B, Sq]`` / ``[B, Skv]`` (tokens attend only
within their segment; ``segment_id < 0`` marks padding, which attends to
nothing and outputs zeros).

Hand-written Hopper kernels replace the four Pallas kernels:

* :func:`flash_fwd` replaces ``_fwd`` (``_fwd_kernel``): tiled online
  softmax over 64-key tiles, tiles above the diagonal skipped under causal
  masking (``csrc/flash_fwd.cu``);
* :func:`flash_fwd_single` replaces ``_fwd_single``
  (``_fwd_single_kernel``): the whole KV of one (batch, head) at once, one
  qkᵀ, one softmax and one pv, no online rescale, and padding skipped:
  a block lists the rows and keys whose segment id is not negative, loads
  only those, and writes the outputs of the other rows (out 0, l 0, m =
  mask_value) without reading them (``csrc/flash_fwd_single.cu``);
* :func:`flash_bwd_dkv` replaces ``_bwd_pallas``'s ``_bwd_dkv_kernel``: dk
  and dv of a 64-key tile, looping over the 64-row q tiles
  (``csrc/flash_bwd.cu``);
* :func:`flash_bwd_dq` replaces ``_bwd_pallas``'s ``_bwd_dq_kernel``: dq
  of a q tile, looping over the kv tiles (``csrc/flash_bwd.cu``);
* :func:`flash_bwd_single` replaces both backward kernels where the
  forward took the single-pass kernel: dq, dk and dv of one (batch, head)
  in one block, the whole KV in shared memory, s and dp formed once per
  (row, key) pair, and padding rows and keys skipped: they get zero
  gradients without being read (``csrc/flash_bwd_single.cu``).

Three of them have two routes, chosen before the launch from the dtype and
the padded head dim alone (:func:`flash_route`): bf16 with D of 64 or 128
goes to the tensor-core kernels (``wgmma``: ``csrc/flash_fwd_tc.cu`` for
:func:`flash_fwd`, ``csrc/flash_bwd_tc.cu`` for :func:`flash_bwd_dkv` and
:func:`flash_bwd_dq`); f32 (any D) and bf16 at the other widths stay on
the CUDA-core kernels above. f32 never takes the tensor cores, whose only
f32 input is TF32 (about three digits). The products of the tensor-core
route are bf16 with f32 accumulation, as the JAX kernels feed the TPU's
matrix unit. :func:`flash_fwd_single` and :func:`flash_bwd_single` have one
route each, on the CUDA cores, and the dispatch sends them only what that
route serves.

Head dims. The JAX kernels take any D, and so do these wrappers: on the
card each pads q, k, v (and do) with zero columns up to the next multiple
of 8 (:func:`pad_head_dim`), the kernels' 16-byte granule, and slices its
outputs back. That is exact: zero columns add exact zeros to q·kᵀ and
do·vᵀ and give zero output columns, so l, m and di do not change.
``sm_scale``'s default comes from the caller's D, before any padding. The
CUDA-core kernels hold at most 128 columns of a tile at a time: above
that, each block writes one 128-column chunk of its output and streams the
full D through its tiles chunk by chunk to form s (and dp), in one fixed
order, so every chunk sees the same s and l, m come from chunk 0. The
single-pass kernels hold a whole D of at most 128, so :func:`single_fits`
sends wider heads to the tiled kernel. The plain
versions take any D unpadded.

Each wrapper launches its kernel on a CUDA tensor and runs the plain PyTorch
version beside it (:func:`fwd_tiled_plain`, :func:`fwd_single_plain`,
:func:`bwd_dkv_plain`, :func:`bwd_dq_plain`) on a CPU tensor; the plain
versions are also the oracles the kernels are held against on the card.
There is no switch and no fallback: a CUDA tensor goes through a kernel or
the wrapper raises. Each wrapper counts its launches in a plain integer
attribute (``flash_fwd.launches``, ...); the routed wrappers also count
them per route (``tc_launches`` and ``cuda_core_launches``).

Routing (:func:`_fwd_dispatch`) keeps the JAX decision "not causal, and the
whole KV fits one block", and adds a third condition: the dtype and head
dim keep the CUDA cores (:func:`flash_route` ``"cuda_core"``), since bf16
at D 64/128 runs faster on the tiled kernel's tensor-core route. On the TPU
a block lives in VMEM (megabytes), so JAX takes the single-step kernel up
to Skv = 4096. An H100 block has at most 227 KB of shared memory, so here
"fits" means that a block of ``csrc/flash_fwd.cu``'s layout holding 64
query rows, the whole K and V, and the 64 × Skv score tile
(:func:`single_smem_bytes`) takes at most half of that. The single-pass
kernels' own layouts (:func:`single_fwd_smem_bytes`,
:func:`single_bwd_smem_bytes`) fit a block wherever it holds. Anything
larger goes to the tiled kernel. Both routes compute the same function.

The backward routes by the same rule (:func:`_bwd_dispatch`): not causal,
:func:`single_fits`, and a dtype and head dim that keep the CUDA cores take
:func:`flash_bwd_single`; everything else takes :func:`flash_bwd_dkv` and
:func:`flash_bwd_dq` on their two routes. So the backward takes the single
pass exactly where the forward did.

Ragged lengths are masked inside the kernels (keys past Skv score
``mask_value``, rows past Sq are not stored), which gives on every real
position what the JAX package's padding with segment −1 gives; no copy of
q, k or v is padded along the sequence.

Gradients: :func:`flash_attention` is a ``torch.autograd.Function``
(``_Flash``, the counterpart of the JAX ``custom_vjp`` ``_flash``) whose
forward saves the l/m residuals and whose backward runs the backward
kernels (:func:`_bwd_dispatch`). :func:`flash_attention_with_lse` stays
primal-only, as in JAX.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..kv.hashing import _M32, _mul32
# the JAX package's _mix_bits is the same murmur3 finalizer as the tables'
from ..kv.hashing import _fmix32 as _mix_bits
from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# The kernels' tiles (csrc/flash_fwd.cu kBQ, kBK), the CUDA-core kernels'
# head-dim chunk (kDC), the head-dim granule and the shared-memory budget.
BLOCK_Q = 64
BLOCK_K = 64
BLOCK_D = 128
HEAD_DIM_ALIGN = 8
SMEM_PER_BLOCK = 232448          # bytes an H100 block may use (227 KB)
_SINGLE_SMEM_MAX = SMEM_PER_BLOCK // 2
# csrc/flash_bwd_single.cu: rows (or keys) one ballot pass lists, listed
# rows per chunk, listed keys per key block
_BWD_SINGLE_SCAN = 128
_BWD_SINGLE_ROWS = 32
_BWD_SINGLE_KEYS = 32
# csrc/flash_fwd_single.cu: the most query rows one block takes, and the
# fewest blocks a launch keeps when blocks take several heads (eight to
# each of an H100's 132 SMs)
_SINGLE_FWD_ROWS = 128
_SINGLE_FWD_MIN_BLOCKS = 8 * 132

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the tensor-core kernels (csrc/flash_fwd_tc.cu,
# csrc/flash_bwd_tc.cu): bf16 only, in 128-byte rows of 64 columns
TC_HEAD_DIMS = (64, 128)
_TC_ALIGN_SLACK = 1024           # those kernels align their tiles to 1 KB
_ptr = ctypes.c_void_p
_int = ctypes.c_int


# ---------------------------------------------------------------------------
# Dropout keep-mask: a counter-based hash of (seed, batch, head, global row,
# global col), bit-identical to the JAX package's _dropout_keep(_dense) and
# to the CUDA kernels' keep(). uint32 arithmetic in int64 masked to 32 bits.
# ---------------------------------------------------------------------------

def _seed_u32(dropout_seed) -> int:
    """The seed as the kernels read it: one int32 word, taken as uint32."""
    if isinstance(dropout_seed, torch.Tensor):
        dropout_seed = dropout_seed.reshape(-1)[0].item()
    elif np.ndim(dropout_seed) != 0:
        dropout_seed = np.asarray(dropout_seed).reshape(-1)[0]
    return int(dropout_seed) & _M32


def _dropout_threshold(p_dropout: float) -> int:
    return min(int(p_dropout * 4294967296.0), 4294967295)


def _dropout_keep_dense(seed, b: int, h: int, sq: int, skv: int,
                        p_dropout: float, row0=0, col0=0,
                        device="cpu") -> torch.Tensor:
    """bool ``[B, H, Sq, Skv]`` keep-mask for global coordinates
    (row0 + i, col0 + j)."""
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    bi = torch.arange(b, **i64)[:, None, None, None]
    hi = torch.arange(h, **i64)[None, :, None, None]
    r = ((torch.arange(sq, **i64) + row0) & _M32)[None, None, :, None]
    c = ((torch.arange(skv, **i64) + col0) & _M32)[None, None, None, :]
    base = ((_seed_u32(seed) * 0x9E3779B9) + _mul32(bi, 0x7FEB352D)
            + _mul32(hi, 0x846CA68B)) & _M32
    x = _mix_bits((base + _mul32(r, 0x27D4EB2F) + c) & _M32)
    return x >= _dropout_threshold(p_dropout)


# ---------------------------------------------------------------------------
# Masks and the exact reference
# ---------------------------------------------------------------------------

def _segment_mask(q_seg, kv_seg) -> torch.Tensor:
    """bool ``[B, Sq, Skv]``: same segment, neither side padding."""
    qs, ks = q_seg[:, :, None], kv_seg[:, None, :]
    return (qs == ks) & (qs >= 0) & (ks >= 0)


def _attention_mask(sq, skv, q_seg, kv_seg, causal, device="cpu"):
    mask = torch.ones((q_seg.shape[0] if q_seg is not None else 1, sq, skv),
                      dtype=torch.bool, device=device)
    if causal:
        row = torch.arange(sq, device=device)[:, None]
        col = torch.arange(skv, device=device)[None, :]
        mask = mask & (col <= row)[None]
    if q_seg is not None:
        mask = mask & _segment_mask(q_seg, kv_seg)
    return mask


def reference_attention(q, k, v, *, causal=False, sm_scale=None,
                        q_segment_ids=None, kv_segment_ids=None,
                        p_dropout: float = 0.0, dropout_seed=0,
                        return_softmax: bool = False):
    """Exact attention (einsum, softmax, einsum), with the same keep-mask as
    the kernels; fully masked rows output 0. Computes in float32, or in
    float64 for float64 inputs (an autograd oracle for the kernels).
    ``return_softmax=True`` also returns the post-dropout probabilities
    ``[B, H, Sq, Skv]`` (0 on fully masked rows), as the JAX package's
    reference does."""
    b, h = q.shape[0], q.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    mask = _attention_mask(q.shape[2], k.shape[2], q_segment_ids,
                           kv_segment_ids, causal, q.device)
    s = torch.where(mask[:, None], s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if p_dropout > 0.0:
        keep = _dropout_keep_dense(dropout_seed, b, h, q.shape[2], k.shape[2],
                                   p_dropout, device=q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - p_dropout))
    any_valid = mask.any(dim=-1)[:, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
    out = torch.where(any_valid, out, 0.0).to(q.dtype)
    if return_softmax:
        return out, torch.where(any_valid, p, 0.0)
    return out


def make_segment_ids_from_lengths(lengths, seq_len: int,
                                  device=None) -> torch.Tensor:
    """Per-example valid length → segment ids (0 for the first ``length``
    tokens, −1 padding)."""
    lengths = torch.as_tensor(lengths, device=device)
    pos = torch.arange(seq_len, device=lengths.device)[None, :]
    return torch.where(pos < lengths[:, None], 0, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions of the two kernels: (out, l, m) with the kernels' residual
# semantics — l sums the probabilities BEFORE dropout; rows that never hit a
# valid key output 0 with l = 0 and m at about mask_value; the mask is ADDED
# to the scores; for bf16, p is rounded to v's dtype before the pv product.
# ---------------------------------------------------------------------------

def _scores(q, k, q_seg, kv_seg, sm_scale, causal, col0=0, row0=0):
    """Scaled, masked f32 scores of the query rows ``q`` that start at row
    ``row0`` against the key tile ``k`` that starts at key ``col0``;
    ``q_seg`` None means no segment mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if sm_scale != 1.0:
        s = s * sm_scale
    mask = None
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[:, None] + row0
        col = torch.arange(k.shape[2], device=q.device)[None, :] + col0
        mask = (col <= row)[None]
    if q_seg is not None:
        seg = _segment_mask(q_seg, kv_seg)
        mask = seg if mask is None else mask & seg
    if mask is not None:
        s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)[:, None]
    return s


def _apply_dropout(p, seed, p_dropout, col0=0, row0=0):
    if p_dropout <= 0.0:
        return p
    b, h, sq, skv = p.shape
    keep = _dropout_keep_dense(seed, b, h, sq, skv, p_dropout, row0=row0,
                               col0=col0, device=p.device)
    return torch.where(keep, p, 0.0) * (1.0 / (1.0 - p_dropout))


def _pv(p, v):
    # p rounded to v's dtype (a no-op for f32), products summed in f32
    return torch.matmul(p.to(v.dtype).float(), v.float())


def fwd_single_plain(q, k, v, q_seg, kv_seg, seed, *, sm_scale: float,
                     p_dropout: float = 0.0):
    """One-pass forward over the whole KV: ``(out, l, m)``."""
    s = _scores(q, k, q_seg, kv_seg, sm_scale, causal=False)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    never_hit = m <= 0.5 * DEFAULT_MASK_VALUE
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = _pv(_apply_dropout(p, seed, p_dropout), v)
    out = torch.where(never_hit, 0.0, o / l_safe).to(q.dtype)
    return out, torch.where(never_hit, 0.0, l)[..., 0], m[..., 0]


def fwd_tiled_plain(q, k, v, q_seg, kv_seg, seed, *, causal: bool,
                    sm_scale: float, p_dropout: float = 0.0):
    """Online-softmax forward over the kernel's 64-key tiles:
    ``(out, l, m)``.
    The kernel skips a tile that lies wholly above its q tile's diagonal;
    here such a tile is computed for every row and changes nothing (each of
    its scores is ``mask_value``, so p = 0 and the rescale is 1 exactly)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    m = torch.full((b, h, sq, 1), -float(np.finfo(np.float32).max),
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for c0 in range(0, skv, BLOCK_K):
        if causal and c0 > sq - 1:
            break                          # above every row's diagonal
        c1 = min(c0 + BLOCK_K, skv)
        s = _scores(q, k[:, :, c0:c1], q_seg,
                    None if kv_seg is None else kv_seg[:, c0:c1],
                    sm_scale, causal, col0=c0)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _pv(_apply_dropout(p, seed, p_dropout, c0),
                                v[:, :, c0:c1])
        m = m_next
    never_hit = m <= 0.5 * DEFAULT_MASK_VALUE
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    out = torch.where(never_hit, 0.0, acc * l_inv).to(q.dtype)
    return out, torch.where(never_hit, 0.0, l)[..., 0], m[..., 0]


# ---------------------------------------------------------------------------
# Plain versions of the two backward kernels, over the kernels' 64 × 64 tile
# pairs, with the Pallas kernels' contract: the mask is ADDED to the scores;
# p = exp(s − m)/l and 0 where l = 0; dv takes the DROPPED p_d, ds the
# undropped p with dp gated and scaled by the keep mask; p_d and ds round to
# q's dtype before their products, which sum in f32; causal tile pairs
# wholly above the diagonal are skipped.
# ---------------------------------------------------------------------------

def _delta(do, out) -> torch.Tensor:
    """``di = Σ(do·o)`` over D, in f32 ``[B, H, Sq]`` (one tensor op, as JAX
    computes it outside its kernels)."""
    return torch.sum(do.float() * out.float(), dim=-1)


def _bwd_tile(q, k, v, do, l, m, di, q_seg, kv_seg, seed, q0, k0, *, causal,
              sm_scale, p_dropout):
    """``(p_d, ds)`` of the q rows starting at ``q0`` against the keys
    starting at ``k0``, each rounded to q's dtype and widened to f32."""
    s = _scores(q, k, q_seg, kv_seg, sm_scale, causal, col0=k0, row0=q0)
    l2, m2 = l[..., None], m[..., None]
    p = torch.exp(s - m2) / torch.where(l2 == 0.0, 1.0, l2)
    p = torch.where(l2 == 0.0, 0.0, p)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    if p_dropout > 0.0:
        b, h, bq, bk = p.shape
        keep = _dropout_keep_dense(seed, b, h, bq, bk, p_dropout, row0=q0,
                                   col0=k0, device=p.device)
        inv = 1.0 / (1.0 - p_dropout)
        p_d = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    else:
        p_d = p
    ds = p * (dp - di[..., None]) * sm_scale
    return p_d.to(q.dtype).float(), ds.to(q.dtype).float()


def bwd_dkv_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, *,
                  causal: bool, sm_scale: float, p_dropout: float = 0.0):
    """dk, dv: per 64-key tile, a loop over the q tiles (``_bwd_dkv_kernel``).
    ``l``, ``m``, ``di`` are f32 ``[B, H, Sq]``."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, k.shape[2], BLOCK_K):
        ks = slice(k0, k0 + BLOCK_K)
        for q0 in range(0, q.shape[2], BLOCK_Q):
            if causal and q0 + BLOCK_Q - 1 < k0:
                continue                   # above the tile pair's diagonal
            qs = slice(q0, q0 + BLOCK_Q)
            p_d, ds = _bwd_tile(
                q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs],
                l[:, :, qs], m[:, :, qs], di[:, :, qs],
                None if q_seg is None else q_seg[:, qs],
                None if kv_seg is None else kv_seg[:, ks], seed, q0, k0,
                causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
            dv[:, :, ks] += torch.matmul(p_d.transpose(-1, -2),
                                         do[:, :, qs].float())
            dk[:, :, ks] += torch.matmul(ds.transpose(-1, -2),
                                         q[:, :, qs].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_dq_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, *,
                 causal: bool, sm_scale: float, p_dropout: float = 0.0):
    """dq: per 64-row q tile, a loop over the kv tiles (``_bwd_dq_kernel``)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, q.shape[2], BLOCK_Q):
        qs = slice(q0, q0 + BLOCK_Q)
        for k0 in range(0, k.shape[2], BLOCK_K):
            if causal and k0 > q0 + BLOCK_Q - 1:
                break                      # above the tile pair's diagonal
            ks = slice(k0, k0 + BLOCK_K)
            _, ds = _bwd_tile(
                q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs],
                l[:, :, qs], m[:, :, qs], di[:, :, qs],
                None if q_seg is None else q_seg[:, qs],
                None if kv_seg is None else kv_seg[:, ks], seed, q0, k0,
                causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
            dq[:, :, qs] += torch.matmul(ds, k[:, :, ks].float())
    return dq.to(q.dtype)


def bwd_plain(q, k, v, q_seg, kv_seg, seed, out, l, m, do, *, causal: bool,
              sm_scale: float, p_dropout: float = 0.0):
    """The whole backward from the forward's residuals: ``(dq, dk, dv)``."""
    di = _delta(do, out)
    kw = dict(causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
    dk, dv = bwd_dkv_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, **kw)
    dq = bwd_dq_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _align16(x: int) -> int:
    return -(-x // 16) * 16


def padded_head_dim(d: int) -> int:
    """The head dim the kernels take for ``d``: the next multiple of 8."""
    return -(-d // HEAD_DIM_ALIGN) * HEAD_DIM_ALIGN


def pad_head_dim(*tensors):
    """Each tensor with its last axis (D) zero-padded to
    :func:`padded_head_dim`; a tensor whose D is a multiple of 8 comes back
    as it is. Exact for attention (see the module note)."""
    return [t if t.shape[-1] % HEAD_DIM_ALIGN == 0 else
            torch.nn.functional.pad(t, (0, padded_head_dim(t.shape[-1])
                                        - t.shape[-1]))
            for t in tensors]


def _unpad(t, d: int):
    """The first ``d`` columns of a kernel's padded output, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _smem_bytes(d: int, n_keys: int, esz: int) -> int:
    """Shared memory of one block, as ``smem_layout`` in flash_fwd.cu lays
    it out: Q tile, K and V of ``n_keys`` rows, the f32 score tile and the
    two segment-id vectors."""
    ld, score_ld = d + 16 // esz, n_keys + 4
    total = _align16(BLOCK_Q * ld * esz)
    total = _align16(total + n_keys * ld * esz)
    total = _align16(total + n_keys * d * esz)
    total = _align16(total + BLOCK_Q * score_ld * 4)
    total = _align16(total + BLOCK_Q * 4)
    return _align16(total + n_keys * 4)


def single_smem_bytes(skv: int, d: int, dtype: torch.dtype) -> int:
    keys = -(-skv // BLOCK_K) * BLOCK_K
    return _smem_bytes(d, keys, torch.empty((), dtype=dtype).element_size())


def single_fits(skv: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the single-pass kernel takes this KV (see the module note):
    a padded D of at most 128, and half a block's shared memory."""
    d = padded_head_dim(d)
    return d <= BLOCK_D and single_smem_bytes(skv, d, dtype) \
        <= _SINGLE_SMEM_MAX


def single_fwd_tile(d: int, segments: bool) -> int:
    """Rows of :func:`flash_fwd_single`'s score tile at the padded D of
    ``d``, with segment ids or without (``tile_rows`` in
    flash_fwd_single.cu): 32 with segments up to D 32, where a small tile
    lets more blocks share an SM, else 64, ``csrc/flash_fwd.cu``'s tile."""
    return 32 if segments and padded_head_dim(d) <= 32 else BLOCK_Q


def single_fwd_config(b: int, h: int, sq: int) -> tuple:
    """``(rows, heads)`` of one :func:`flash_fwd_single` block, from the
    shapes alone: it takes ``rows`` positional query rows of ``heads``
    heads of one batch row. Sq of 65-128 is one 128-row chunk per problem;
    other queries are split into 64-row chunks across blocks (a block's Q
    space follows ``rows``, so short queries keep a 64-row block's
    shared memory). A block takes as many heads (up to 8) as keep the grid
    at least
    ``_SINGLE_FWD_MIN_BLOCKS`` blocks: the heads of one batch row share
    their segment ids, so the block lists them once and loads the heads'
    listed rows together, which pays where each head holds little work
    (BST's heads), and costs parallelism where few problems hold much."""
    rows = _SINGLE_FWD_ROWS if BLOCK_Q < sq <= _SINGLE_FWD_ROWS else BLOCK_Q
    chunks = b * -(-sq // rows)
    heads = 8
    while heads > 1 and chunks * -(-h // heads) < _SINGLE_FWD_MIN_BLOCKS:
        heads //= 2
    return rows, min(heads, h)


def single_fwd_smem_bytes(skv: int, d: int, dtype: torch.dtype,
                          rows: int = _SINGLE_FWD_ROWS,
                          segments: bool = True) -> int:
    """Shared memory of one :func:`flash_fwd_single` block at the padded D
    of ``d``, as ``smem_layout`` in flash_fwd_single.cu lays it out: Q of
    ``rows`` rows and K of Skv rounded up to 64 rows (rows padded by 16
    bytes), V of as many rows, the f32 score tile of
    :func:`single_fwd_tile` rows by those keys plus 4, the keys' positions
    and segments, the rows' positions, segments and flags, and the ballot
    counts."""
    d = padded_head_dim(d)
    tile = single_fwd_tile(d, segments)
    esz = torch.empty((), dtype=dtype).element_size()
    ld, keys = d + 16 // esz, -(-skv // BLOCK_K) * BLOCK_K
    total = _align16(rows * ld * esz)                      # Q
    total = _align16(total + keys * ld * esz)              # K
    total = _align16(total + keys * d * esz)               # V
    total = _align16(total + tile * (keys + 4) * 4)        # scores
    total += 2 * keys * 4 + 3 * rows * 4
    return _align16(total + (_BWD_SINGLE_SCAN // 32) * 4)


def single_bwd_smem_bytes(skv: int, d: int, dtype: torch.dtype) -> int:
    """Shared memory of one :func:`flash_bwd_single` block at the padded
    D of ``d``, as ``smem_layout`` in flash_bwd_single.cu lays it out: K
    and V of ``skv`` rows (rows padded by 16 bytes) and f32 dk, dv
    accumulators; a chunk's Q and dO rows and f32 dq; the f32 p_d and ds
    tiles; the chunk rows' l, m, di, segment and position; a scan window's
    listed rows and flags; the keys' positions, segments and slots; the
    ballot counts."""
    d = padded_head_dim(d)
    esz = torch.empty((), dtype=dtype).element_size()
    ld, rows = d + 16 // esz, _BWD_SINGLE_ROWS
    total = _align16(skv * ld * esz)                       # K
    total = _align16(total + skv * ld * esz)               # V
    total = _align16(total + skv * d * 4)                  # dk
    total = _align16(total + skv * d * 4)                  # dv
    total = _align16(total + rows * ld * esz)              # Q
    total = _align16(total + rows * ld * esz)              # dO
    total = _align16(total + rows * d * 4)                 # dq
    tile = rows * (_BWD_SINGLE_KEYS + 1) * 4
    total = _align16(total + tile)                         # p_d
    total = _align16(total + tile)                         # ds
    total += 5 * rows * 4 + 2 * _BWD_SINGLE_SCAN * 4 + 3 * skv * 4
    return _align16(total + (_BWD_SINGLE_SCAN // 32) * 4)


_TAIL = [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
         ctypes.c_float, _ptr]


def flash_route(dtype: torch.dtype, d: int) -> str:
    """Which kernel :func:`flash_fwd`, :func:`flash_bwd_dkv` and
    :func:`flash_bwd_dq` launch for this dtype and head dim: ``"tc"`` (the
    tensor-core kernels) for bf16 at a padded D of 64 or 128, else
    ``"cuda_core"``. Nothing else decides it, and no route is retried on
    the other."""
    return "tc" if dtype == torch.bfloat16 \
        and padded_head_dim(d) in TC_HEAD_DIMS else "cuda_core"


def tc_fwd_smem_bytes(d: int) -> int:
    """Shared memory of one tensor-core forward block, as ``Layout`` in
    flash_fwd_tc.cu lays it out: the bf16 Q tile, two stages of K and V
    tiles (64 rows each), two stages of 64 key segment ids, and the
    alignment slack."""
    tile = BLOCK_Q * d * 2
    return 5 * tile + 2 * BLOCK_K * 4 + _TC_ALIGN_SLACK


def tc_dkv_smem_bytes(d: int) -> int:
    """Shared memory of one tensor-core dk/dv block, as ``Layout`` in
    flash_bwd_tc.cu lays it out: the resident K and V tiles, two stages of
    Q and dO tiles, two stages of the q tile's l, m, di and segment ids,
    and the alignment slack."""
    tile = BLOCK_K * d * 2
    return 6 * tile + 2 * 4 * BLOCK_Q * 4 + _TC_ALIGN_SLACK


def tc_dq_smem_bytes(d: int) -> int:
    """Shared memory of one tensor-core dq block, as ``DqLayout`` in
    flash_bwd_tc.cu lays it out: the resident Q and dO tiles, two stages of
    K and V tiles, two stages of 64 key segment ids, and the alignment
    slack."""
    tile = BLOCK_Q * d * 2
    return 6 * tile + 2 * BLOCK_K * 4 + _TC_ALIGN_SLACK


def _count(fn, route: str) -> None:
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)


def _flash_lib() -> ctypes.CDLL:
    lib = _build.library("flash_fwd")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_fwd.argtypes = [_ptr] * 8 + [_int] * 7 + _TAIL
        lib.tfp_flash_fwd.restype = _int
        lib._tfp_typed = True
    return lib


def _flash_fwd_single_lib() -> ctypes.CDLL:
    lib = _build.library("flash_fwd_single")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_fwd_single_skip.argtypes = [_ptr] * 8 + [_int] * 8 \
            + _TAIL
        lib.tfp_flash_fwd_single_skip.restype = _int
        lib.tfp_flash_fwd_single_skip_smem.argtypes = [_int] * 5
        lib.tfp_flash_fwd_single_skip_smem.restype = ctypes.c_longlong
        lib._tfp_typed = True
    return lib


def _flash_tc_lib() -> ctypes.CDLL:
    lib = _build.library("flash_fwd_tc")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_fwd_tc.argtypes = [_ptr] * 8 + [_int] * 7 + _TAIL
        lib.tfp_flash_fwd_tc.restype = _int
        lib._tfp_typed = True
    return lib


def _flash_bwd_tc_lib() -> ctypes.CDLL:
    lib = _build.library("flash_bwd_tc")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_bwd_dkv_tc.argtypes = [_ptr] * 11 + [_int] * 7 + _TAIL
        lib.tfp_flash_bwd_dkv_tc.restype = _int
        lib.tfp_flash_bwd_dq_tc.argtypes = [_ptr] * 10 + [_int] * 7 + _TAIL
        lib.tfp_flash_bwd_dq_tc.restype = _int
        lib._tfp_typed = True
    return lib


def _flash_bwd_single_lib() -> ctypes.CDLL:
    lib = _build.library("flash_bwd_single")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_bwd_single.argtypes = [_ptr] * 12 + [_int] * 6 + _TAIL
        lib.tfp_flash_bwd_single.restype = _int
        lib.tfp_flash_bwd_single_smem.argtypes = [_int] * 3
        lib.tfp_flash_bwd_single_smem.restype = ctypes.c_longlong
        lib._tfp_typed = True
    return lib


def _flash_bwd_lib() -> ctypes.CDLL:
    lib = _build.library("flash_bwd")
    if not getattr(lib, "_tfp_typed", False):
        lib.tfp_flash_bwd_dkv.argtypes = [_ptr] * 11 + [_int] * 7 + _TAIL
        lib.tfp_flash_bwd_dkv.restype = _int
        lib.tfp_flash_bwd_dq.argtypes = [_ptr] * 10 + [_int] * 7 + _TAIL
        lib.tfp_flash_bwd_dq.restype = _int
        lib._tfp_typed = True
    return lib


def _check(q, k, v, q_seg, kv_seg) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not agree")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("provide both or neither segment id array")
    tensors = [q, k, v] + ([] if q_seg is None else [q_seg, kv_seg])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and the segment ids must share one device")
    if q_seg is not None:
        if q_seg.dtype != torch.int32 or kv_seg.dtype != torch.int32:
            raise TypeError("segment ids must be int32")
        if (q_seg.shape != (b, q.shape[2])
                or kv_seg.shape != (b, k.shape[2])):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    if q.is_cuda:
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA flash kernels take contiguous tensors")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the CUDA flash kernels take q, k, v aligned "
                             "to 16 bytes")


def _check_bwd(q, do, l, m, di) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}")
    for t in (l, m, di):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError("l, m and di must be float32 [B, H, Sq] on q's "
                             "device")
    if q.is_cuda:
        if not all(t.is_contiguous() for t in (do, l, m, di)):
            raise ValueError("the CUDA flash kernels take contiguous tensors")
        if do.data_ptr() % 16:
            raise ValueError("the CUDA flash kernels take do aligned to 16 "
                             "bytes")


def _kernel_tail(seed, sm_scale, p_dropout, device):
    return [float(sm_scale), DEFAULT_MASK_VALUE, _seed_u32(seed),
            _dropout_threshold(p_dropout) if p_dropout > 0 else 0,
            1.0 / (1.0 - p_dropout), torch.cuda.current_stream(device).cuda_stream]


def _ptr_of(t):
    return None if t is None else t.data_ptr()


def _launch(lib, fn_name, q, k, v, q_seg, kv_seg, seed, sm_scale, p_dropout,
            save_residuals, mid=()):
    """``mid``: the kernel's int arguments after the dtype (the causal flag,
    or the single-pass kernel's rows and heads per block)."""
    b, h, sq, d = q.shape
    if q.numel() == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs B, H, Sq, Skv, D > 0")
    out = torch.empty_like(q)
    l = m = None
    if save_residuals:
        l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)

    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr_of(q_seg),
            _ptr_of(kv_seg), out.data_ptr(), _ptr_of(l), _ptr_of(m), b, h,
            sq, k.shape[2], d, _DTYPES[q.dtype]]
    err = getattr(lib, fn_name)(
        *head, *mid, *_kernel_tail(seed, sm_scale, p_dropout, q.device))
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")
    return out, l, m


def flash_fwd(q, k, v, q_seg, kv_seg, seed, *, causal: bool, sm_scale: float,
              p_dropout: float = 0.0, save_residuals: bool = True):
    """Tiled forward: ``(out, l, m)``, or ``(out, None, None)`` without
    residuals (the kernel then writes no l and m). On the card the route
    (:func:`flash_route`) picks the tensor-core or the CUDA-core kernel."""
    _check(q, k, v, q_seg, kv_seg)
    if not q.is_cuda:
        out, l, m = fwd_tiled_plain(q, k, v, q_seg, kv_seg, seed,
                                    causal=causal, sm_scale=sm_scale,
                                    p_dropout=p_dropout)
        return (out, l, m) if save_residuals else (out, None, None)
    d = q.shape[3]
    route = flash_route(q.dtype, d)
    lib, fn_name = ((_flash_tc_lib(), "tfp_flash_fwd_tc") if route == "tc"
                    else (_flash_lib(), "tfp_flash_fwd"))
    out, l, m = _launch(lib, fn_name, *pad_head_dim(q, k, v), q_seg, kv_seg,
                        seed, sm_scale, p_dropout, save_residuals,
                        mid=(int(causal),))
    _count(flash_fwd, route)
    return _unpad(out, d), l, m


flash_fwd.launches = flash_fwd.tc_launches = 0
flash_fwd.cuda_core_launches = 0


def flash_fwd_single(q, k, v, q_seg, kv_seg, seed, *, sm_scale: float,
                     p_dropout: float = 0.0, save_residuals: bool = True):
    """Single-pass non-causal forward: ``(out, l, m)`` (or
    ``(out, None, None)``). On the card the KV and D must fit the block
    (:func:`single_fits`)."""
    _check(q, k, v, q_seg, kv_seg)
    if not q.is_cuda:
        out, l, m = fwd_single_plain(q, k, v, q_seg, kv_seg, seed,
                                     sm_scale=sm_scale, p_dropout=p_dropout)
        return (out, l, m) if save_residuals else (out, None, None)
    if not single_fits(k.shape[2], q.shape[3], q.dtype):
        raise ValueError(f"Skv {k.shape[2]} at D {q.shape[3]} does not fit "
                         "the single-pass kernel's block")
    out, l, m = _launch(_flash_fwd_single_lib(), "tfp_flash_fwd_single_skip",
                        *pad_head_dim(q, k, v), q_seg, kv_seg, seed, sm_scale,
                        p_dropout, save_residuals,
                        mid=single_fwd_config(*q.shape[:3]))
    flash_fwd_single.launches += 1
    return _unpad(out, q.shape[3]), l, m


flash_fwd_single.launches = 0


def _single_pass(q, k, causal) -> bool:
    """The dispatches' rule: the single-pass kernels when not causal, the
    whole KV fits one block and the CUDA cores serve the dtype and D
    (:func:`flash_route`). Else the tiled kernels: causal keeps them for
    their tile skip, and bf16 at D 64/128 takes their tensor-core route,
    which the H100 runs several times faster than the single pass on the
    CUDA cores (PERF.md)."""
    d = q.shape[3]
    return (not causal and single_fits(k.shape[2], d, q.dtype)
            and flash_route(q.dtype, d) == "cuda_core")


def _fwd_dispatch(q, k, v, q_seg, kv_seg, seed, causal, sm_scale, p_dropout,
                  save_residuals):
    """:func:`flash_fwd_single` or :func:`flash_fwd`, by
    :func:`_single_pass`."""
    if _single_pass(q, k, causal):
        return flash_fwd_single(q, k, v, q_seg, kv_seg, seed,
                                sm_scale=sm_scale, p_dropout=p_dropout,
                                save_residuals=save_residuals)
    return flash_fwd(q, k, v, q_seg, kv_seg, seed, causal=causal,
                     sm_scale=sm_scale, p_dropout=p_dropout,
                     save_residuals=save_residuals)


def _launch_bwd(lib, fn_name, outs, q, k, v, q_seg, kv_seg, seed, do, l, m,
                di, causal, sm_scale, p_dropout):
    """``causal`` None: the kernel takes no causal flag (not causal)."""
    b, h, sq, d = q.shape
    if q.numel() == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs B, H, Sq, Skv, D > 0")
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            l.data_ptr(), m.data_ptr(), di.data_ptr(), _ptr_of(q_seg),
            _ptr_of(kv_seg), *(t.data_ptr() for t in outs), b, h, sq,
            k.shape[2], d, _DTYPES[q.dtype]]
    if causal is not None:
        args.append(int(causal))
    err = getattr(lib, fn_name)(
        *args, *_kernel_tail(seed, sm_scale, p_dropout, q.device))
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def flash_bwd_dkv(q, k, v, q_seg, kv_seg, seed, do, l, m, di, *,
                  causal: bool, sm_scale: float, p_dropout: float = 0.0):
    """dk, dv from the forward's residuals l, m and ``di = Σ(do·o)`` (f32
    ``[B, H, Sq]``), in k's and v's dtype. On the card the route
    (:func:`flash_route`) picks the tensor-core or the CUDA-core kernel."""
    _check(q, k, v, q_seg, kv_seg)
    _check_bwd(q, do, l, m, di)
    kw = dict(causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
    if not q.is_cuda:
        return bwd_dkv_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, **kw)
    d = q.shape[3]
    route = flash_route(q.dtype, d)
    lib, fn_name = ((_flash_bwd_tc_lib(), "tfp_flash_bwd_dkv_tc")
                    if route == "tc"
                    else (_flash_bwd_lib(), "tfp_flash_bwd_dkv"))
    q, k, v, do = pad_head_dim(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(lib, fn_name, (dk, dv), q, k, v, q_seg, kv_seg, seed, do, l,
                m, di, **kw)
    _count(flash_bwd_dkv, route)
    return _unpad(dk, d), _unpad(dv, d)


flash_bwd_dkv.launches = flash_bwd_dkv.tc_launches = 0
flash_bwd_dkv.cuda_core_launches = 0


def flash_bwd_dq(q, k, v, q_seg, kv_seg, seed, do, l, m, di, *,
                 causal: bool, sm_scale: float, p_dropout: float = 0.0):
    """dq from the same inputs as :func:`flash_bwd_dkv`, in q's dtype. On
    the card the route (:func:`flash_route`) picks the tensor-core or the
    CUDA-core kernel."""
    _check(q, k, v, q_seg, kv_seg)
    _check_bwd(q, do, l, m, di)
    kw = dict(causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
    if not q.is_cuda:
        return bwd_dq_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di, **kw)
    d = q.shape[3]
    route = flash_route(q.dtype, d)
    lib, fn_name = ((_flash_bwd_tc_lib(), "tfp_flash_bwd_dq_tc")
                    if route == "tc"
                    else (_flash_bwd_lib(), "tfp_flash_bwd_dq"))
    q, k, v, do = pad_head_dim(q, k, v, do)
    dq = torch.empty_like(q)
    _launch_bwd(lib, fn_name, (dq,), q, k, v, q_seg, kv_seg, seed, do, l, m,
                di, **kw)
    _count(flash_bwd_dq, route)
    return _unpad(dq, d)


flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0
flash_bwd_dq.cuda_core_launches = 0


def flash_bwd_single(q, k, v, q_seg, kv_seg, seed, do, l, m, di, *,
                     sm_scale: float, p_dropout: float = 0.0):
    """Non-causal backward in one launch: ``(dq, dk, dv)`` in q's, k's and
    v's dtype, from the same inputs as :func:`flash_bwd_dkv`. On a CPU
    tensor the plain versions of the two backward kernels; on the card the
    KV and D must fit the block (:func:`single_fits`)."""
    _check(q, k, v, q_seg, kv_seg)
    _check_bwd(q, do, l, m, di)
    if not q.is_cuda:
        kw = dict(causal=False, sm_scale=sm_scale, p_dropout=p_dropout)
        dk, dv = bwd_dkv_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di,
                               **kw)
        return bwd_dq_plain(q, k, v, q_seg, kv_seg, seed, do, l, m, di,
                            **kw), dk, dv
    d = q.shape[3]
    if not single_fits(k.shape[2], d, q.dtype):
        raise ValueError(f"Skv {k.shape[2]} at D {d} does not fit the "
                         "single-pass backward kernel's block")
    q, k, v, do = pad_head_dim(q, k, v, do)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    _launch_bwd(_flash_bwd_single_lib(), "tfp_flash_bwd_single", outs, q, k,
                v, q_seg, kv_seg, seed, do, l, m, di, causal=None,
                sm_scale=sm_scale, p_dropout=p_dropout)
    flash_bwd_single.launches += 1
    return tuple(_unpad(t, d) for t in outs)


flash_bwd_single.launches = 0


def _bwd_dispatch(q, k, v, q_seg, kv_seg, seed, do, l, m, di, causal,
                  sm_scale, p_dropout):
    """``(dq, dk, dv)``: :func:`flash_bwd_single` where the forward took the
    single pass (:func:`_single_pass`); else :func:`flash_bwd_dkv` and
    :func:`flash_bwd_dq`."""
    if _single_pass(q, k, causal):
        return flash_bwd_single(q, k, v, q_seg, kv_seg, seed, do, l, m, di,
                                sm_scale=sm_scale, p_dropout=p_dropout)
    kw = dict(causal=causal, sm_scale=sm_scale, p_dropout=p_dropout)
    dk, dv = flash_bwd_dkv(q, k, v, q_seg, kv_seg, seed, do, l, m, di, **kw)
    return flash_bwd_dq(q, k, v, q_seg, kv_seg, seed, do, l, m, di,
                        **kw), dk, dv


class _Flash(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` ``_flash``: the forward kernel
    with residuals saved, and the backward kernels (:func:`_bwd_dispatch`)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, seed, causal, sm_scale,
                p_dropout):
        out, l, m = _fwd_dispatch(q, k, v, q_seg, kv_seg, seed, causal,
                                  sm_scale, p_dropout, save_residuals=True)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, l, m)
        ctx.opts = (seed, dict(causal=causal, sm_scale=sm_scale,
                               p_dropout=p_dropout))
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, out, l, m = ctx.saved_tensors
        seed, kw = ctx.opts
        # autograd may hand back a strided view (flash_attention_layer's
        # transpose)
        do = _ready(do)
        di = _delta(do, out)
        dq, dk, dv = _bwd_dispatch(q, k, v, q_seg, kv_seg, seed, do, l, m,
                                   di, **kw)
        return dq, dk, dv, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------

def _ready(t):
    """Contiguous, and on the card 16-byte aligned, as the kernels take it."""
    t = t.contiguous()
    return t.clone() if t.is_cuda and t.data_ptr() % 16 else t


def _prepare(q, k, v, sm_scale, q_segment_ids, kv_segment_ids, p_dropout):
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("provide both or neither segment id array")
    if not (0.0 <= p_dropout < 1.0):
        raise ValueError(f"p_dropout must be in [0, 1), got {p_dropout}")

    def seg(s):
        return None if s is None else torch.as_tensor(
            s, dtype=torch.int32, device=q.device).contiguous()

    return (_ready(q), _ready(k), _ready(v), seg(q_segment_ids),
            seg(kv_segment_ids), float(sm_scale), float(p_dropout))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    q_segment_ids=None, kv_segment_ids=None,
                    block_q: int = 1024, block_k: int = 1024,
                    block_k_inner: Optional[int] = None,
                    p_dropout: float = 0.0, dropout_seed=0,
                    interpret: Optional[bool] = None):
    """Flash attention. q ``[B, H, Sq, D]``, k/v ``[B, H, Skv, D]``;
    optional int32 segment ids ``[B, Sq]`` / ``[B, Skv]`` (−1 = padding);
    arbitrary sequence lengths. ``p_dropout``/``dropout_seed``: inverted
    dropout on the probabilities from the counter hash, the same mask as the
    JAX package's for the same seed.

    ``block_q``, ``block_k``, ``block_k_inner`` and ``interpret`` are
    accepted so that callers of the JAX function port unchanged; none of
    them changes a result or a launch here: the kernels' tiles are their own
    (64 query rows by 64 keys), the ragged edge is masked inside them, and
    there is no interpreter (the tensors' device picks kernel or plain
    version). Differentiable in q, k and v: with autograd on and an input
    that requires grad, the forward saves its residuals and the backward
    runs :func:`flash_bwd_single`, or :func:`flash_bwd_dkv` and
    :func:`flash_bwd_dq` (:func:`_bwd_dispatch`)."""
    del block_q, block_k, block_k_inner, interpret
    q, k, v, qs, ks, sm_scale, p_dropout = _prepare(
        q, k, v, sm_scale, q_segment_ids, kv_segment_ids, p_dropout)
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, qs, ks, dropout_seed, causal, sm_scale,
                            p_dropout)
    out, _, _ = _fwd_dispatch(q, k, v, qs, ks, dropout_seed, causal,
                              sm_scale, p_dropout, save_residuals=False)
    return out


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             q_segment_ids=None, kv_segment_ids=None,
                             block_q: int = 1024, block_k: int = 1024,
                             block_k_inner: Optional[int] = None,
                             p_dropout: float = 0.0, dropout_seed=0,
                             interpret: Optional[bool] = None):
    """Forward returning ``(out, softmax_lse)``: lse ``[B, H, Sq]`` is the
    PRE-dropout log-sum-exp of the masked scores, ``m + log(l)``, and
    ``-inf`` on rows that never hit a valid key. Arguments as
    :func:`flash_attention`. Primal-only, as in the JAX package: with
    autograd on and an input that requires grad, raises
    ``NotImplementedError`` (use :func:`flash_attention` for gradients)."""
    del block_q, block_k, block_k_inner, interpret
    if _needs_grad(q, k, v):
        raise NotImplementedError("flash_attention_with_lse is primal-only; "
                                  "use flash_attention for gradients")
    q, k, v, qs, ks, sm_scale, p_dropout = _prepare(
        q, k, v, sm_scale, q_segment_ids, kv_segment_ids, p_dropout)
    out, l, m = _fwd_dispatch(q, k, v, qs, ks, dropout_seed, causal,
                              sm_scale, p_dropout, save_residuals=True)
    hit = l > 0.0
    lse = torch.where(hit, m + torch.log(torch.where(hit, l, 1.0)),
                      -math.inf)
    return out, lse
