"""Int8 row-quantized serving tables: a quarter of the payload bytes.

Counterpart of ``tfplus_tpu/kv/quant.py``, bit for bit: an inference-only
table whose payload is symmetric per-row int8 (``scale = max|row| / 127``,
1.0 for an all-zero row, ``q = round(row / scale)`` half to even). The f32
scale sits in the header's pad lanes (48-63, one 32-bit word per slot, its
bits viewed as int32), so the probe's bucket read brings it along with the
keys and meta: a lookup is one probe (``find(want_pad=True)``) and one int8
row gather. The keys and meta lanes are the source table's, so ``find``,
blacklisted rows reading as zeros and shard routing behave as for a
``KvTable``.

Training stays in full precision; quantize after training:

    qt = quant.quantize_table(table)         # or load_for_serving(quantize=True)
    rows = quant.lookup_or_zeros(qt, ids)    # dequantized f32

The int8 rows are gathered with plain PyTorch indexing (the JAX package uses
``jnp.take`` there, not a Pallas kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import hashing
from . import table as kvt


@dataclasses.dataclass
class QuantKvTable:
    # planar header [C//16, 64]: lanes 0-47 as in KvTable (keys + packed
    # meta); lanes 48-63 hold each slot's f32 dequantization scale, viewed
    # as int32
    header: torch.Tensor
    payload: torch.Tensor        # int8[C, D]
    config: kvt.KvConfig

    @property
    def capacity(self) -> int:
        return self.header.shape[0] * hashing.BUCKET_SIZE

    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def device(self) -> torch.device:
        return self.header.device

    @property
    def scale(self) -> torch.Tensor:
        """Per-row dequantization scale f32[C], read from the pad lanes (a
        copy; the lookup takes the scale from its probe instead)."""
        return kvt._get_all_pad(self.header).view(torch.float32)

    @property
    def nbytes(self) -> int:
        return (self.payload.numel() * self.payload.element_size()
                + self.header.numel() * self.header.element_size())


def quantize_rows(rows: torch.Tensor):
    """Symmetric per-row int8: ``(q, scale)`` with ``q = round(v / scale)``
    computed in f32."""
    r = rows.float()
    absmax = r.abs().amax(dim=-1)
    # divide by a tensor: on the card, PyTorch divides by a Python number
    # as a product with its reciprocal, which may round the scale apart
    # from the CPU's (and JAX's) IEEE quotient
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    q = torch.clamp(torch.round(r / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_table(table: kvt.KvTable) -> QuantKvTable:
    """An int8 serving copy of a trained table. Optimizer slots are dropped
    (the config's slot layout is cleared); the header is copied, with every
    slot's scale written into its pad lanes. ``table`` is left unchanged."""
    q, scale = quantize_rows(table.payload[:, :table.config.dim])
    cfg = dataclasses.replace(table.config, slot_layout=())
    header = kvt._set_all_pad(table.header.clone(), scale.view(torch.int32))
    return QuantKvTable(header=header, payload=q, config=cfg)


def lookup_or_zeros(table: QuantKvTable, q: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """Inference gather with dequantization; unknown and blacklisted keys
    read as zeros (the contract of ``kv.lookup_or_zeros``). The probe brings
    each row's scale from the pad lanes, so the only other read is the
    int8 row gather."""
    fr = kvt.find(table, q, valid, want_pad=True)
    ok = fr.found & ((fr.meta & kvt.FLAG_BLACKLIST) == 0)
    rows_q = table.payload[torch.where(ok, fr.slot, 0).long()]
    # fold the miss/blacklist zeroing into the per-row scale ([N] work, not
    # a second pass over the [N, D] rows)
    scale = torch.where(ok, fr.pad.view(torch.float32), 0.0)
    return rows_q.to(dtype) * scale[:, None].to(dtype)


def max_quant_error(table: kvt.KvTable) -> float:
    """Largest absolute dequantization error over the live rows (a host
    diagnostic): at most max|row| / 254 per element by construction."""
    qt = quantize_table(table)
    occ = kvt.occupied_mask(table)
    deq = qt.payload.float() * qt.scale[:, None]
    err = torch.where(occ[:, None],
                      (deq - table.payload[:, :table.dim].float()).abs(), 0.0)
    return float(err.max())
