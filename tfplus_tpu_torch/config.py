"""Typed configuration tree: per-table options and process-wide switches.

Counterpart of ``tfplus_tpu/config.py``: the same classes, fields, defaults
and environment variables, field for field, except two fields that steer
only the JAX package and are left out here:

* ``enable_pallas_rowops`` chose the Pallas row kernels over XLA's gathers.
  The port has one rule instead: a CUDA tensor always goes through the row
  kernel (``ops/rowops.py``), a CPU tensor through its plain version.
* ``compile_cache_dir`` pointed XLA's persistent compilation cache at a
  directory. The port compiles no programs per table shape.

Per-table options mirror the reference's KvOptions / StorageConfig; the
storage enums are kept for checkpoint compatibility.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class StorageType(enum.IntEnum):
    """Storage tiers: device memory, and host DRAM as the spill tier."""
    MEM_STORAGE = 0          # device memory (the hot KvTable)
    HOST_MEM_STORAGE = 1     # host-DRAM tier


class StorageCombination(enum.IntEnum):
    MEM = 0
    MEM_HOST = 1             # device hot tier + host-DRAM spill


@dataclasses.dataclass(frozen=True)
class KvStorageConfig:
    """Storage tier config of one table."""
    combination: StorageCombination = StorageCombination.MEM
    capacity: int = 0                # 0 = unbounded (grow on demand)
    # MEM_HOST tier policy: device live-row budget and optional cold
    # criteria; 0 = unset
    max_live: int = 0
    min_freq: int = 0
    older_than_days: int = 0


@dataclasses.dataclass(frozen=True)
class KvOptions:
    """Per-table options."""
    storage: KvStorageConfig = dataclasses.field(default_factory=KvStorageConfig)
    enter_threshold: int = 0         # frequency filter
    ttl_days: int = 0                # 0 = no time-based eviction


@dataclasses.dataclass
class RuntimeConfig:
    """Process-wide switches, read from the environment by :meth:`from_env`."""
    inference_only: bool = False
    support_delta_export: bool = True
    support_prediction_delta_export: bool = False
    default_capacity: int = 1 << 14
    grow_load_factor: float = 0.7

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        def flag(name, default):
            v = os.environ.get(name)
            return default if v is None else v not in ("0", "false", "False", "")
        return cls(
            inference_only=flag("TFPLUS_TPU_INFERENCE_ONLY", False),
            support_delta_export=flag("SUPPORT_DELTA_EXPORT", True),
            support_prediction_delta_export=flag(
                "SUPPORT_PREDICTION_DELTA_EXPORT", False),
        )


_runtime: Optional[RuntimeConfig] = None


def runtime() -> RuntimeConfig:
    """The process's :class:`RuntimeConfig`, read from the environment on
    the first call."""
    global _runtime
    if _runtime is None:
        _runtime = RuntimeConfig.from_env()
    return _runtime
