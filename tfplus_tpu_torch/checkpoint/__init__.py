"""Checkpoints of KV tables and dense state: bundles, save and restore (full
and delta, streamed), elastic repartition and the full/delta lineage
manager. Bundles are interchangeable with the JAX package's. The TFPlus
bridge (``tf_import``, ``tf_export``) reads and writes TensorFlow
TensorBundles through the port's own reader and writer (``tf_bundle``)."""
from . import (bundle, crc32c, manager, repartition, saver, tf_bundle,
               tf_export, tf_import)
from .bundle import BundleReader, BundleWriter
from .tf_bundle import TFBundleReader, TFBundleWriter, write_bundle
from .manager import CheckpointManager
from .saver import (FIRST_N_DELTA, FIRST_N_INFERENCE, FIRST_N_KV,
                    FIRST_N_TRAIN, AsyncSave, UnionReader, restore,
                    restore_multihost, restore_table, save, save_async,
                    save_multihost, save_table)
