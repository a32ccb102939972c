"""Inputs made from the seed: per-purpose seeds, table ids, rows, init
pools and dense weights. The program and the reference are handed the same.

A table of ``n`` resident ids holds ``key(i) = 2**40 + (i*A + C) mod 2**40``
for ``i < n`` (``A`` odd, so the map is one to one, and ``C`` from the seed);
its row ``i`` is row ``i`` of ``0.05 * randn(n, dim)`` drawn on the device
from the table's seed. Ids from ``FRESH_BASE`` up are never resident.
"""
from __future__ import annotations

import hashlib

import torch

SPAN = 1 << 40
MASK = SPAN - 1
FRESH_BASE = 1 << 41
ROW_SCALE = 0.05            # the scale of KvVariable's default init pool
POOL_ROWS = 10000           # init pool rows, as the port's tables default
_A = 0x9E3779B97F4A7C15 & MASK | 1
_A_INV = pow(_A, -1, SPAN)


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose of a run with ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def _offset(seed: int, table: str) -> int:
    return derive(seed, "ids", table) & MASK


def key_of(idx: torch.Tensor, seed: int, table: str) -> torch.Tensor:
    """Resident ids of row indices ``idx`` (int64)."""
    return SPAN + ((_mul40(idx, _A) + _offset(seed, table)) & MASK)


def _mul40(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**40`` for ``x`` in ``[0, 2**40)`` inside int64."""
    lo, hi = c & 0xFFFFF, c >> 20
    return (x * lo + (((x * hi) & 0xFFFFF) << 20)) & MASK


def index_of(ids: torch.Tensor, seed: int, table: str, n: int):
    """``(row index, resident)`` of int64 ``ids`` in a table of ``n``."""
    inside = (ids >= SPAN) & (ids < 2 * SPAN)
    idx = _mul40((ids - SPAN - _offset(seed, table)) & MASK, _A_INV)
    return torch.where(inside, idx, 0), inside & (idx < n)


def encode(ids: torch.Tensor) -> torch.Tensor:
    """int64 ids (< 2**63) as the ``int32[N, 2]`` (low, high) key words."""
    lo = ((ids & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return torch.stack([lo, ids >> 32], dim=-1).to(torch.int32)


def table_rows(seed: int, table: str, n: int, dim: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """The ``[n, dim]`` rows of a table's resident ids."""
    g = generator(seed, device, "rows", table)
    return torch.randn((n, dim), generator=g, device=device,
                       dtype=dtype) * ROW_SCALE


def init_pool(seed: int, table: str, dim: int, device) -> torch.Tensor:
    """The init pool that fresh ids of a table start from."""
    g = generator(seed, device, "pool", table)
    return torch.randn((POOL_ROWS, dim), generator=g,
                       device=device) * ROW_SCALE


def dense_weights(seed: int, spec, device) -> dict:
    """Weights by name from ``spec``: ``(name, shape, init)`` with init
    ``["normal", scale]``, ``["ones"]`` or ``["zeros"]``, drawn in one
    call."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, "dense"),
                       device=device)
    out, at = {}, 0
    for (name, shape, init), size in zip(spec, sizes):
        x = flat[at:at + size].reshape(shape)
        at += size
        if init[0] == "normal":
            out[name] = x * init[1]
        elif init[0] == "ones":
            out[name] = torch.ones_like(x)
        else:
            out[name] = torch.zeros_like(x)
    return out
