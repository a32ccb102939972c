"""Checkpoints of KV tables and dense state: bundles, save and restore (full
and delta, streamed), elastic repartition and the full/delta lineage
manager. Bundles are interchangeable with the JAX package's."""
from . import bundle, manager, repartition, saver
from .bundle import BundleReader, BundleWriter
from .manager import CheckpointManager
from .saver import (FIRST_N_DELTA, FIRST_N_INFERENCE, FIRST_N_KV,
                    FIRST_N_TRAIN, AsyncSave, UnionReader, restore,
                    restore_multihost, restore_table, save, save_async,
                    save_multihost, save_table)
