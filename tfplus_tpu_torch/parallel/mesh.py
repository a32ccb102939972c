"""Process groups and the collectives of the distributed tier.

Counterpart of ``tfplus_tpu/parallel/mesh.py``. The JAX package runs one
controller over a device mesh and its per-device bodies run inside
``shard_map`` over an axis name. The port runs ONE PROCESS PER RANK: each
rank holds its own shard as a plain :class:`~tfplus_tpu_torch.kv.table.KvTable`
and the bodies take a process group (``None`` is the default group) where the
JAX package takes ``axis_name``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's dim
names; ``mesh.get_group(name)`` is the group a body takes.

Collectives map one for one (every rank gets the same answer, as JAX's
replicated scalars give):

* ``all_to_all(x.reshape(S, cap, ...), tiled=False)``: :func:`all_to_all`,
  ``all_to_all_single`` with equal splits (chunk j goes to rank j, what
  arrives is ordered by source);
* ``psum`` / ``pmax``: :func:`all_reduce` (``pmean`` divides by the size);
* ``ppermute`` to ``(i + shift) % n``: :func:`ppermute`, one
  ``all_to_all_single`` whose split sizes are zero except toward the
  neighbour, which NCCL and gloo both take for host and card tensors;
* ``all_gather``: :func:`all_gather`.

Entry points run on ``cuda:<LOCAL_RANK>`` over NCCL unless the caller names
the CPU and a ``gloo`` group, as the tests do. Nothing picks another backend
or device on its own, and no tensor is copied to the host for a backend:
a CUDA tensor that a group cannot take raises in ``torch.distributed``.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

TABLE_AXIS = "mp"


def default_device() -> torch.device:
    """``cuda:<LOCAL_RANK>``, the card of this rank (``LOCAL_RANK`` as
    ``torchrun`` sets it, 0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(num_devices: Optional[int] = None, axis_name: str = TABLE_AXIS,
              device_type: str = "cuda"):
    """1-D ``DeviceMesh`` over every rank: batch AND tables are both sharded
    over it (every rank owns 1/N of each table and 1/N of the global
    batch). ``num_devices`` must be the world size when given. Collective:
    every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"a mesh of {num_devices} ranks in a world of {n}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: str = "nccl") -> bool:
    """Join the process group of a multi-process run: ``init_method``
    (``env://`` by default, which reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` as ``torchrun`` sets them). With NCCL the
    rank's card is ``cuda:<LOCAL_RANK>``. Returns True when a group of more
    than one process is up; False, joining nothing, when neither an
    ``init_method``, a ``world_size`` nor ``WORLD_SIZE`` names one. A
    group that is named but cannot be joined raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None \
            and "WORLD_SIZE" not in os.environ:
        return False
    if backend == "nccl":
        torch.cuda.set_device(default_device())
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return dist.get_world_size() > 1


# ---------------------------------------------------------------------------
# collectives (every rank of the group calls each of them)
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [S·cap, ...] in S equal chunks along dim 0: chunk j goes to
    rank j; the result holds rank j's chunk for this rank at chunk j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``psum`` / ``pmax`` / ``pmin`` of a tensor: a new tensor, ``x``
    untouched."""
    out = x.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX,
                             "min": dist.ReduceOp.MIN}[op], group=group)
    return out


def all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on every rank), in rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    outs = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(outs, x, group=group)
    return outs


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``: this
    rank's ``x`` goes to rank ``(i + shift) % n`` and the result is rank
    ``(i - shift) % n``'s. One ``all_to_all_single`` with split sizes that
    are zero except toward the two neighbours."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    send = [0] * n
    recv = [0] * n
    send[(me + shift) % n] = flat.numel()
    recv[(me - shift) % n] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out.view(x.shape)


def any_true(flag, group=None, device=None) -> bool:
    """True on every rank when ``flag`` (a bool or a 0-d tensor) is true
    on any rank (a ``pmax`` read on the host)."""
    if isinstance(flag, torch.Tensor):
        t = flag.reshape(()).to(torch.int32)
    else:
        t = torch.tensor(int(bool(flag)), dtype=torch.int32, device=device)
    return bool(all_reduce(t, "max", group).item())


def host_max(value: int, group=None, device=None) -> int:
    """The largest of every rank's Python int, on every rank."""
    t = torch.tensor(int(value), dtype=torch.int64, device=device)
    return int(all_reduce(t, "max", group).item())


def host_sum(value, group=None, device=None) -> int:
    """The sum of every rank's int (a Python int or a 0-d tensor)."""
    t = (value.reshape(()).to(torch.int64) if isinstance(value, torch.Tensor)
         else torch.tensor(int(value), dtype=torch.int64, device=device))
    return int(all_reduce(t, "sum", group).item())
