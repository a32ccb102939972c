"""Layer-level flash attention in the reference layer's ``[B, S, H, D]``
layout, with padding from an attention mask or lengths expressed as segment
ids (−1 = padding). Counterpart of ``tfplus_tpu/nn/attention.py``."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import flash_attention as fa


def flash_attention_layer(q, k, v, *, attention_mask=None, lengths=None,
                          causal: bool = False,
                          softmax_scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128,
                          p_dropout: float = 0.0, dropout_seed=0,
                          interpret: Optional[bool] = None):
    """q/k/v: ``[B, S, H, D]``. Either ``attention_mask`` ``[B, S]``
    (nonzero = valid) or ``lengths`` ``[B]`` describes padding. Returns
    ``[B, S, H, D]`` with padded positions zeroed. ``block_q``, ``block_k``
    and ``interpret`` are accepted as :func:`fa.flash_attention` accepts
    them."""
    s = q.shape[1]
    if attention_mask is not None:
        seg = torch.where(torch.as_tensor(attention_mask, device=q.device)
                          .bool(), 0, -1).to(torch.int32)
    elif lengths is not None:
        seg = fa.make_segment_ids_from_lengths(lengths, s, device=q.device)
    else:
        seg = None
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             sm_scale=softmax_scale, q_segment_ids=seg,
                             kv_segment_ids=seg, block_q=block_q,
                             block_k=block_k, p_dropout=p_dropout,
                             dropout_seed=dropout_seed, interpret=interpret)
    return out.transpose(1, 2)
