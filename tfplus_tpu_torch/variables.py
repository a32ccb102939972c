"""KvVariable store: the ``get_kv_variable`` user surface.

Counterpart of ``tfplus_tpu/variables.py``: a named table registry that
creates a table (or ``num_shards`` shards named ``name/part_i``, seeded
``seed + i``) on first request and returns the same one afterwards, plus the
module-level saver-mode switches (``set_tfplus_saver_mode``: 0 = prediction,
whose checkpoints carry ``first_n = 3`` tensors per table; 1 = training,
``first_n = 6``). The port's tables update in place, so a table fetched
once stays current; a grown table is a new one, which :meth:`update` puts
back.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

from .checkpoint import saver as _saver
from .kv import table as kvt


class KvVariableStore:
    """Named table registry."""

    def __init__(self):
        self._tables: Dict[str, Union[kvt.KvTable, list]] = {}
        self._lock = threading.Lock()
        self.is_training: bool = True
        self.saver_mode: int = 1          # 1=training, 0=prediction

    def get_kv_variable(self, name: str, embedding_dim: int, *,
                        capacity: int = 1 << 14,
                        key_dtype=None,               # accepted for parity
                        initializer=None,
                        enter_threshold: int = 0,
                        num_shards: int = 1,
                        partitioner=None,
                        value_dtype=torch.float32,
                        seed: int = 0,
                        device="cuda"):
        """Create or fetch a table. ``partitioner`` (an object with
        ``num_shards``, or a ``tf.fixed_size_partitioner``-style callable)
        overrides ``num_shards``. A second request for ``name`` returns the
        stored table, or raises if its dim differs."""
        del key_dtype  # all keys are 64-bit here
        if partitioner is not None:
            num_shards = _partitioner_shards(partitioner)
        with self._lock:
            if name in self._tables:
                existing = self._tables[name]
                t0 = existing[0] if isinstance(existing, list) else existing
                if t0.dim != embedding_dim:
                    raise ValueError(
                        f"{name}: dim mismatch {t0.dim} != {embedding_dim}")
                return existing

            def make(shard_name, shard_seed):
                return kvt.create(embedding_dim, capacity,
                                  initializer=initializer,
                                  enter_threshold=enter_threshold,
                                  value_dtype=value_dtype, name=shard_name,
                                  seed=shard_seed, device=device)
            if num_shards == 1:
                self._tables[name] = make(name, seed)
            else:
                self._tables[name] = [make(f"{name}/part_{i}", seed + i)
                                      for i in range(num_shards)]
            return self._tables[name]

    def update(self, name: str, table):
        """Store a new table under ``name`` (after a grow, which returns a
        new table)."""
        with self._lock:
            self._tables[name] = table

    def __getitem__(self, name: str):
        return self._tables[name]

    def __contains__(self, name: str):
        return name in self._tables

    def tables(self) -> Dict[str, Union[kvt.KvTable, list]]:
        return dict(self._tables)

    def get_kv_feature_size(self) -> Dict[str, int]:
        """Live rows per variable, summed over its shards."""
        out = {}
        for name, t in self._tables.items():
            shards = t if isinstance(t, list) else [t]
            out[name] = sum(int(kvt.size(s)) for s in shards)
        return out

    def set_training(self, training: bool):
        self.is_training = training

    def set_saver_mode(self, mode: int):
        """0 = prediction (export ``first_n = 3``), 1 = training
        (``first_n = 6``)."""
        self.saver_mode = mode

    @property
    def save_first_n(self) -> int:
        return (_saver.FIRST_N_TRAIN if self.saver_mode
                else _saver.FIRST_N_INFERENCE)


_DEFAULT_STORE = KvVariableStore()


def default_store() -> KvVariableStore:
    return _DEFAULT_STORE


def get_kv_variable(name: str, embedding_dim: int, **kwargs):
    """TF1-style convenience on the global default store."""
    return _DEFAULT_STORE.get_kv_variable(name, embedding_dim, **kwargs)


def set_tfplus_saver_mode(mode: int):
    _DEFAULT_STORE.set_saver_mode(mode)


class _ProbeDim:
    """Quacks like ``tf.compat.v1.Dimension`` for partitioner probing."""

    def __init__(self, value):
        self.value = value

    def __index__(self):
        return self.value

    def __int__(self):
        return self.value


class _ProbeShape:
    """Quacks like ``tf.TensorShape``: TF's fixed_size_partitioner closure
    does ``[1] * shape.ndims`` then ``min(num_shards, shape.dims[axis].value)``,
    so a huge leading dim makes it return exactly num_shards partitions on
    the partitioned axis."""

    def __init__(self, dims):
        self.dims = [_ProbeDim(d) for d in dims]
        self.ndims = len(dims)
        self.rank = len(dims)

    def __len__(self):
        return self.ndims

    def __getitem__(self, i):
        return self.dims[i]

    def num_elements(self):
        out = 1
        for d in self.dims:
            out *= d.value
        return out


def _partitioner_shards(partitioner) -> int:
    """num_shards of a partitioner: its ``num_shards`` attribute, or what a
    ``tf.fixed_size_partitioner``-style closure returns for a huge shape."""
    n = getattr(partitioner, "num_shards", None)
    if n is None and callable(partitioner):
        try:
            parts = partitioner(shape=_ProbeShape((1 << 60, 1)), dtype=None)
            n = max(int(p) for p in parts)
        except Exception:
            try:  # keyword-less closures
                parts = partitioner(_ProbeShape((1 << 60, 1)), None)
                n = max(int(p) for p in parts)
            except Exception:
                n = None
    if n is None:
        raise ValueError(
            "partitioner must expose num_shards or be a "
            "tf.fixed_size_partitioner-style callable (use "
            "tfplus_tpu_torch.fixed_size_partitioner(N))")
    return int(n)


class fixed_size_partitioner:
    """Stand-in for ``tf.fixed_size_partitioner``: carries ``num_shards``
    for ``get_kv_variable(partitioner=...)``."""

    def __init__(self, num_shards: int, axis: int = 0):
        del axis
        self.num_shards = int(num_shards)

    def __call__(self, shape=None, dtype=None):
        return [1] * self.num_shards


def tfplus_saver_mode() -> int:
    """Current saver mode of the default store (0 = prediction/inference,
    1 = training)."""
    return _DEFAULT_STORE.saver_mode


def get_kv_feature_size():
    return _DEFAULT_STORE.get_kv_feature_size()
