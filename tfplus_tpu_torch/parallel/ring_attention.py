"""Ring attention: sequence (context) parallelism over a process group.

Counterpart of ``tfplus_tpu/parallel/ring_attention.py``. K/V shards rotate
around the ring of ranks (:func:`~tfplus_tpu_torch.parallel.mesh.ppermute`)
while each rank accumulates its queries' attention with online-softmax
merging: the total traffic is one all-gather's. Every rank calls the
functions with its own sequence shard, q ``[B, H, Sq_l, D]`` and k/v
``[B, H, Skv_l, D]``; causal masking uses each block's global position.

Two block computes ship, as in the JAX package:

* :func:`ring_attention`, the blockwise online softmax in plain PyTorch
  (differentiable by autograd, through the rotations too), with dropout
  masks in global coordinates: a ring-sharded run drops exactly the
  entries the single-rank reference drops for the same seed;
* :func:`ring_flash_attention`, the flash kernels per ring block (the
  forward with its l/m residuals, ``ops.flash_attention._fwd_dispatch``;
  the backward kernels through ``_bwd_dispatch``, fed the GLOBAL l and m),
  whose memory stays O(S_local).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from . import mesh as _mesh

_NEG = -0.7 * float(np.finfo(np.float32).max)
_M32 = 0xFFFFFFFF


class _PPermute(torch.autograd.Function):
    """``ppermute`` by ``shift`` whose gradient goes back by ``-shift``."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _mesh.ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _mesh.ppermute(g, ctx.group, -ctx.shift), None, None


class _AllReduceSum(torch.autograd.Function):
    """``psum`` whose gradient is the psum of the gradients (every rank's
    loss reads the replicated sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mesh.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _mesh.all_reduce(g.contiguous(), "sum", ctx.group), None


def _dropout_keep_block(seed, b, h, sq, skv, row0, col0, p_dropout: float,
                        device) -> torch.Tensor:
    """[B, H, sq, skv] keep-mask for GLOBAL coordinates (row0 + i,
    col0 + j): the flash kernels' hash with offsets, so that a
    ring-sharded sequence drops exactly the entries the single-rank kernel
    drops for the same seed, whatever the ring's order."""
    return fa._dropout_keep_dense(seed, b, h, sq, skv, p_dropout, row0=row0,
                                  col0=col0, device=device)


def _local_block(q, k, v, sm_scale, causal, q_off, kv_off, p_dropout=0.0,
                 seed=0):
    """One (q_local × kv_block) attention partial → (acc, l, m)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    sq, skv = q.shape[2], k.shape[2]
    if causal:
        row = q_off + torch.arange(sq, device=q.device)[:, None]
        col = kv_off + torch.arange(skv, device=q.device)[None, :]
        s = torch.where((col <= row)[None, None], s,
                        torch.full_like(s, _NEG))
    m = torch.amax(s, dim=-1)                                  # [B,H,Sq]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)        # the lse normaliser stays pre-dropout
    if p_dropout > 0.0:
        keep = _dropout_keep_block(seed, q.shape[0], q.shape[1], sq, skv,
                                   q_off, kv_off, p_dropout, q.device)
        p = torch.where(keep, p, torch.zeros_like(p)) \
            * (1.0 / (1.0 - p_dropout))
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return acc, l, m


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   sm_scale: Optional[float] = None, p_dropout: float = 0.0,
                   dropout_seed=0):
    """q [B,H,Sq_l,D], k/v [B,H,Skv_l,D]: this rank's sequence shards.
    Returns this rank's output shard [B,H,Sq_l,D].

    ``p_dropout``/``dropout_seed``: attention dropout with the flash
    kernels' global-coordinate masks (the same entries as the single-rank
    kernel drops for the same seed)."""
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    b, h, sq_l, d = q.shape
    skv_l = k.shape[2]
    q_off = my * sq_l
    dev = q.device
    m = torch.full((b, h, sq_l), -np.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq_l), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq_l, d), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (my - step) % n                    # who this block came from
        a_i, l_i, m_i = _local_block(q, k_blk, v_blk, sm_scale, causal,
                                     q_off, src * skv_l, p_dropout,
                                     dropout_seed)
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_i - m_new)
        acc = acc * alpha[..., None] + a_i * beta[..., None]
        l = l * alpha + l_i * beta
        m = m_new
        if step < n - 1:
            k_blk = _PPermute.apply(k_blk, group, 1)
            v_blk = _PPermute.apply(v_blk, group, 1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    # rows with no valid key anywhere read zeros
    out = torch.where((m > 0.5 * _NEG)[..., None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _block_seed(dropout_seed, src: int, step: int) -> int:
    """Per-ring-block dropout seed, int32 arithmetic as the JAX package's
    (``seed + src * 0x9E3D + step``, wrapped), so that the masks match."""
    s = (int(fa._seed_u32(dropout_seed)) + src * 0x9E3D + step) & _M32
    return s - (1 << 32) if s >= (1 << 31) else s


def _combine(acc, l, m, a_i, l_i, m_i):
    """Online-softmax merge of a block partial; a block whose m is -inf
    (skipped, or a row that saw no key) adds nothing."""
    big = 0.5 * _NEG
    m_new = torch.maximum(m, m_i)
    alpha = torch.exp(torch.clamp(m, min=big) - torch.clamp(m_new, min=big))
    beta = torch.exp(torch.clamp(m_i, min=big) - torch.clamp(m_new, min=big))
    alpha = torch.where(m == -np.inf, torch.zeros_like(alpha), alpha)
    beta = torch.where(m_i == -np.inf, torch.zeros_like(beta), beta)
    return (acc * alpha[..., None] + a_i * beta[..., None],
            l * alpha + l_i * beta, m_new)


def _visible(causal: bool, step: int, src: int, my: int):
    """The block's causal flag, or None when a causal block lies wholly
    after this rank's queries and is skipped. Block pairs are always the
    diagonal (this rank's own kv: causal inside), wholly visible (kv from
    an earlier rank) or wholly masked (a later one)."""
    if not causal:
        return False
    if step == 0:
        return True
    return False if src < my else None


def _ring_flash_fwd(q, k, v, group, causal, sm_scale, p_dropout, seed):
    """Forward ring sweep → (out, l, m) with GLOBAL online-softmax stats."""
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    b, h, sq_l, d = q.shape
    dev = q.device
    m = torch.full((b, h, sq_l), -np.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq_l), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq_l, d), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (my - step) % n
        blk_causal = _visible(causal, step, src, my)
        if blk_causal is not None:
            out_i, l_i, m_i = fa._fwd_dispatch(
                q, k_blk, v_blk, None, None, _block_seed(seed, src, step),
                blk_causal, sm_scale, p_dropout, save_residuals=True)
            # un-normalise: the kernel returns out = acc / l
            a_i = out_i.float() * l_i[..., None]
            acc, l, m = _combine(acc, l, m, a_i, l_i, m_i)
        if step < n - 1:
            k_blk = _mesh.ppermute(k_blk, group)
            v_blk = _mesh.ppermute(v_blk, group)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    out = torch.where((l > 0.0)[..., None], out, torch.zeros_like(out))
    return out.to(q.dtype), l, m


class _RingFlash(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp`` ``_ring_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale, p_dropout, seed):
        out, l, m = _ring_flash_fwd(q, k, v, group, causal, sm_scale,
                                    p_dropout, seed)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.opts = (group, causal, sm_scale, p_dropout, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        """Every block's (dq, dk, dv) from the flash backward kernels fed
        the GLOBAL (l, m), so that p is the global softmax probability and
        the block gradients sum to the exact gradient. dq accumulates here;
        dk and dv accumulate in buffers that travel WITH the kv blocks and
        take one last hop home."""
        q, k, v, out, l, m = ctx.saved_tensors
        group, causal, sm_scale, p_dropout, seed = ctx.opts
        n = dist.get_world_size(group)
        my = dist.get_rank(group)
        do = fa._ready(do)
        di = fa._delta(do, out)          # once, from the global out
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            src = (my - step) % n
            blk_causal = _visible(causal, step, src, my)
            if blk_causal is not None:
                dq_i, dk_i, dv_i = fa._bwd_dispatch(
                    q, k_blk, v_blk, None, None,
                    _block_seed(seed, src, step), do, l, m, di, blk_causal,
                    sm_scale, p_dropout)
                dq = dq + dq_i.float()
                dk_blk = dk_blk + dk_i.float()
                dv_blk = dv_blk + dv_i.float()
            if step < n - 1:
                k_blk = _mesh.ppermute(k_blk, group)
                v_blk = _mesh.ppermute(v_blk, group)
                dk_blk = _mesh.ppermute(dk_blk, group)
                dv_blk = _mesh.ppermute(dv_blk, group)
        # after n-1 rotations the block owned by o sits on rank o-1: one
        # more hop returns the accumulated dk/dv to their owners
        dk_blk = _mesh.ppermute(dk_blk, group)
        dv_blk = _mesh.ppermute(dv_blk, group)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, *, group=None, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         p_dropout: float = 0.0, dropout_seed=0,
                         block_q: int = 512, block_k: int = 512,
                         interpret: Optional[bool] = None):
    """Ring attention with the FLASH KERNELS as the per-block compute: no
    [Sq_l, Skv_l] score matrix is formed, so memory stays O(S_local).

    A ring block pair is always the diagonal (causal flash), wholly visible
    (non-causal flash) or wholly masked (skipped). Differentiable in q, k
    and v (the backward kernels per block with the global l and m).

    Dropout uses a per-(source shard, step) seed, replayed in the backward;
    its masks are not the single-rank kernel's (use :func:`ring_attention`
    for that). ``block_q``, ``block_k`` and ``interpret`` are accepted so
    that callers of the JAX function port unchanged: the kernels' tiles are
    their own, and the tensors' device picks kernel or plain version."""
    del block_q, block_k, interpret
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    q, k, v = fa._ready(q), fa._ready(k), fa._ready(v)
    if fa._needs_grad(q, k, v):
        return _RingFlash.apply(q, k, v, group, causal, float(sm_scale),
                                float(p_dropout), dropout_seed)
    return _ring_flash_fwd(q, k, v, group, causal, float(sm_scale),
                           float(p_dropout), dropout_seed)[0]


def context_parallel_attention(q, k_shard, v_shard, *, group=None,
                               causal: bool = False,
                               sm_scale: Optional[float] = None,
                               p_dropout: float = 0.0, dropout_seed=0):
    """One collective round instead of a ring: q is the same on every rank;
    each rank computes a partial against its KV shard and the partials
    merge with a cross-rank online-softmax combine (max, then sums)."""
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    my = dist.get_rank(group)
    skv_l = k_shard.shape[2]
    acc, l, m = _local_block(q, k_shard, v_shard, sm_scale, causal, 0,
                             my * skv_l, p_dropout, dropout_seed)
    # the stabiliser's gradient cancels: the merge reads it detached
    m_g = _mesh.all_reduce(m.detach(), "max", group)
    corr = torch.exp(m - m_g)
    l_g = _AllReduceSum.apply(l * corr, group)
    acc_g = _AllReduceSum.apply(acc * corr[..., None], group)
    l_safe = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    out = acc_g / l_safe[..., None]
    out = torch.where((m_g > 0.5 * _NEG)[..., None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)
