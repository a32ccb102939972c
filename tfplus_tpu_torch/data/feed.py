"""Packed single-buffer batch feed.

Counterpart of ``tfplus_tpu/data/feed.py``. A DCN batch (26 id columns,
the numeric features and the labels) fed leaf by leaf is 28 host-to-device
copies, each its own launch and wait on the host. ``make_packed_feed``
writes the whole batch tree into ONE int32 host tensor, pinned when the
feed targets a CUDA device, so the caller makes one asynchronous copy;
``unpack`` then cuts the device buffer back into the batch's leaves as
views (a slice and a ``view(dtype)``), copying nothing on the card.

A batch tree is nested dicts (keys in sorted order, as JAX flattens them),
lists and tuples of numpy arrays with 4-byte items: float32, int32 (the
``[N, 2]`` encoded id pairs) and uint32. A uint32 leaf comes back as an
int32 tensor holding the same bits (the way ``kv/table.py`` keeps its meta
words), since PyTorch has few uint32 operations.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from ..utils import device as _dev

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.uint32): torch.int32}


def _flatten(tree: Any, leaves: List[Any]):
    """Append ``tree``'s leaves to ``leaves`` in JAX's order and return its
    structure (leaves replaced by ``None``). ``None`` in the tree is an
    empty subtree, as in JAX."""
    if tree is None:
        return ("none", ())
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(tree[k], leaves))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, items = spec
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in items}
    out = [_unflatten(s, leaves) for s in items]
    return tuple(out) if kind == "tuple" else out


def make_packed_feed(example_batch: Any, device="cuda") -> Tuple[
        Callable[[Any], torch.Tensor], Callable[[torch.Tensor], Any]]:
    """Build ``(pack, unpack)`` for batches shaped like ``example_batch``.

    ``pack(batch) -> torch.int32[total_words]`` on the host: every leaf
    written into one tensor by one ``np.concatenate(..., out=...)``. For a
    CUDA ``device`` the tensor is pinned and new for each batch (PyTorch's
    caching host allocator hands a block out again only after the copies
    that used it have finished), so the caller's
    ``flat.to(device, non_blocking=True)`` cannot see it refilled.
    ``unpack(flat) -> batch`` returns views of ``flat``. A batch must have
    the example's structure, shapes and dtypes, else ``ValueError``;
    ``unpack`` rejects a buffer of another length.
    """
    pin = _dev.resolve(device).type == "cuda"
    leaves: List[Any] = []
    treedef = _flatten(example_batch, leaves)
    specs = []
    off = 0
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype.itemsize != 4:
            raise ValueError(
                f"packed feed requires 4-byte dtypes, got {a.dtype} "
                f"(encode ids to int32 pairs first)")
        if a.dtype not in _DTYPES:
            raise ValueError(f"packed feed takes float32, int32 and uint32 "
                             f"leaves, got {a.dtype}")
        n = int(a.size)
        specs.append((a.shape, a.dtype, off, n))
        off += n
    total = off

    def pack(batch: Any) -> torch.Tensor:
        ls: List[Any] = []
        if _flatten(batch, ls) != treedef:
            raise ValueError("batch structure differs from the example")
        parts = []
        for leaf, (shape, dtype, _, _) in zip(ls, specs):
            a = np.asarray(leaf)
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(
                    f"leaf {a.shape}/{a.dtype} != example {shape}/{dtype}")
            parts.append(np.ascontiguousarray(a).view(np.int32).ravel())
        flat = torch.empty((total,), dtype=torch.int32, pin_memory=pin)
        np.concatenate(parts, out=flat.numpy())
        return flat

    def unpack(flat: torch.Tensor) -> Any:
        if tuple(flat.shape) != (total,) or flat.dtype != torch.int32:
            raise ValueError(f"packed buffer must be int32[{total}], "
                             f"got {flat.dtype}{list(flat.shape)}")
        out = []
        for shape, dtype, o, n in specs:
            seg = flat[o:o + n]
            if _DTYPES[dtype] != torch.int32:
                seg = seg.view(_DTYPES[dtype])
            out.append(seg.view(shape))
        return _unflatten(treedef, iter(out))

    return pack, unpack
