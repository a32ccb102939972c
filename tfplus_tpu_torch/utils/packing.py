"""Per-row metadata packing: one 32-bit word per row.

Same layout as the JAX package's ``tfplus_tpu/utils/packing.py``:

    bits  0..15  saturating visit frequency
    bits 16..28  day of last update, mod 8192
    bit  29      group-lasso blacklist
    bit  30      train delta-list membership
    bit  31      prediction delta-list membership

Checkpoints carry the reference's ``freq | unix_day << 16`` word instead
(:func:`reference_word_np`), as the JAX package's do.

Torch has no usable uint32 arithmetic on the CPU (no ``>>`` or ``%``), so a
meta word is held as an ``int64`` tensor whose value lies in ``[0, 2**32)``.
The table header stores it bit-exactly as ``int32`` (``kv.table._meta_i32``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

FREQ_MASK = 0xFFFF
MAX_FREQ = 0xFFFF
DAY_BITS = 13
DAY_MASK = 0x1FFF
FLAGS_MASK = 0xE0000000

FLAG_BLACKLIST = 1 << 29
FLAG_TOUCH_TRAIN = 1 << 30
FLAG_TOUCH_PRED = 1 << 31
FLAG_TOUCH_BOTH = 0b11 << 30


def _u32(x) -> torch.Tensor:
    """Any integer tensor or Python int → int64 tensor holding its uint32
    value (negative int32 words wrap to their unsigned value)."""
    return torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF


def pack(freq, day, flags=0) -> torch.Tensor:
    word = ((_u32(day) & DAY_MASK) << 16) | (_u32(freq) & FREQ_MASK)
    return word | (_u32(flags) & FLAGS_MASK)


def get_freq(meta: torch.Tensor) -> torch.Tensor:
    return _u32(meta) & FREQ_MASK


def get_day(meta: torch.Tensor) -> torch.Tensor:
    return (_u32(meta) >> 16) & DAY_MASK


def get_flags(meta: torch.Tensor) -> torch.Tensor:
    return _u32(meta) & FLAGS_MASK


def day_age(now_day, row_day) -> torch.Tensor:
    """Wraparound-safe ``now - row_day`` over the 13-bit day ring."""
    return ((_u32(now_day) & DAY_MASK) - _u32(row_day)) & DAY_MASK


def saturating_add_freq(meta: torch.Tensor, add: torch.Tensor,
                        day) -> torch.Tensor:
    """freq = min(freq + add, 0xFFFF); day = now; flag bits preserved."""
    f = torch.clamp(get_freq(meta) + _u32(add), max=MAX_FREQ)
    return pack(f, day, get_flags(meta))


def current_day() -> int:
    """Host-side day stamp (unix seconds // 86400)."""
    return int(time.time()) // 86400


def to_reference_word(meta: torch.Tensor) -> torch.Tensor:
    """Strip flags → the reference's ``freq | day<<16`` checkpoint word."""
    return get_freq(meta) | (get_day(meta) << 16)


def from_reference_word(word: torch.Tensor, flags=0) -> torch.Tensor:
    return pack(_u32(word) & FREQ_MASK, _u32(word) >> 16, flags)


def reference_day_np(meta: np.ndarray, as_of_unix_day=None) -> np.ndarray:
    """The reference's full 16-bit unix day from the in-table 13-bit ring
    (numpy, host-side): ``today − ring_age``. Exact for rows stamped with
    :func:`current_day`-derived days within the last 8192 days."""
    now = current_day() if as_of_unix_day is None else int(as_of_unix_day)
    ring_now = now & DAY_MASK
    ring_row = (np.asarray(meta, np.uint32) >> 16) & DAY_MASK
    age = (np.int64(ring_now) - ring_row.astype(np.int64)) & DAY_MASK
    return ((np.int64(now) - age) & 0xFFFF).astype(np.uint32)


def reference_word_np(meta: np.ndarray, as_of_unix_day=None) -> np.ndarray:
    """The reference's on-disk ``freq | unix_day<<16`` word (numpy)."""
    m = np.asarray(meta, np.uint32)
    return ((m & np.uint32(FREQ_MASK))
            | (reference_day_np(m, as_of_unix_day) << np.uint32(16)))
