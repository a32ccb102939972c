"""SparseOptimizer — applies a row-update rule to a KvTable's touched rows.

Counterpart of ``tfplus_tpu/optim/base.py``. The batch of unique touched
rows goes through one gather → rule → scatter region on the table, IN PLACE
(the port's tables are updated in place, see :mod:`tfplus_tpu_torch.kv.table`):

* frequency filter: rows with freq < ``enter_threshold`` are skipped;
* group-lasso blacklist: blacklisted rows read as zero for the update, and
  the rule's mask flags or un-flags each updated row;
* the update math runs in float32 whatever the payload's dtype, with one
  rounding at the store;
* ONE wide row scatter (``ops.rowops.scatter_rows``, the CUDA kernel on the
  card) writes the variable and its slot columns together, built by
  concatenation, and ONE meta write marks the rows touched;
* ``payload_rows``/``meta_rows`` from the same step's lookup replace both
  gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kv import table as kvt
from ..ops import rowops
from ..utils import packing
from .rules import Rule


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Binds a :class:`Rule` to a slot name; stateless (all state lives in
    the table's slot columns, so checkpoints carry optimizer state)."""
    rule: Rule
    slot_name: str = "opt_state"

    def init(self, table: kvt.KvTable) -> kvt.KvTable:
        """The table with this optimizer's slot columns (a new table when
        the payload widens; call once, before training)."""
        if self.rule.slot_width == 0:
            return table
        return kvt.ensure_slots(table, {self.slot_name: self.rule.slot_width})

    def apply(self, table: kvt.KvTable, slot_idx: torch.Tensor,
              grads: torch.Tensor, *, lr, step,
              extra: Optional[torch.Tensor] = None,
              mark_delta: bool = True,
              payload_rows: Optional[torch.Tensor] = None,
              meta_rows: Optional[torch.Tensor] = None) -> kvt.KvTable:
        """Update rows at ``slot_idx`` (``LookupResult.slot``; -1 entries
        are skipped) with per-unique-row ``grads``, in place. ``step`` is
        the 1-indexed global step; ``lr`` a float or a 0-d tensor."""
        n = slot_idx.shape[0]
        cap = table.capacity
        dim = table.config.dim
        k = self.rule.slot_width
        if k > 0 and self.slot_name not in table.config.slot_columns():
            raise ValueError(f"slot '{self.slot_name}' missing — call "
                             "optimizer.init(table) first")
        ok = slot_idx >= 0
        if meta_rows is None:
            safe = torch.where(ok, slot_idx, 0).long()
            meta_g = kvt._meta_u32(table.header.view(-1)[kvt._hpos_meta(safe)])
        else:
            meta_g = meta_rows

        thr = table.config.enter_threshold
        if thr > 0:
            ok = ok & (packing.get_freq(meta_g) >= thr)

        gidx = torch.where(ok, slot_idx, -1).to(torch.int32)
        wide = (rowops.gather_rows(table.payload, gidx)
                if payload_rows is None else payload_rows)
        var = wide[:, :dim]
        was_black = (meta_g & kvt.FLAG_BLACKLIST) != 0
        var = torch.where(was_black[:, None], torch.zeros_like(var), var)
        if k > 0:
            s, w = table.config.slot_columns()[self.slot_name]
            state = wide[:, s:s + w]
        else:
            state = var.new_zeros((n, 0))

        new_var, new_state, black = self.rule.update(
            var.float(), state.float(), grads.float(), lr=lr, step=step,
            extra=extra)

        pieces = [new_var.to(wide.dtype)]
        if k > 0:
            if s > dim:
                pieces.append(wide[:, dim:s])
            pieces.append(new_state.to(wide.dtype))
            if s + w < wide.shape[1]:
                pieces.append(wide[:, s + w:])
        elif wide.shape[1] > dim:
            pieces.append(wide[:, dim:])
        new_wide = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)
        rowops.scatter_rows(table.payload, gidx, new_wide.contiguous())

        new_meta = meta_g
        if mark_delta:
            new_meta = new_meta | kvt.FLAG_TOUCH_BOTH
        if black is not None:
            new_meta = torch.where(black, new_meta | kvt.FLAG_BLACKLIST,
                                   new_meta & ~kvt.FLAG_BLACKLIST)
        else:
            new_meta = new_meta & ~kvt.FLAG_BLACKLIST
        kvt._set_meta_at(table.header, torch.where(ok, slot_idx, cap),
                         new_meta)
        return table
