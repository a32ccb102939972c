"""The port stands alone: importing tfplus_tpu_torch, every submodule
(the optimizer suite, the training step, the checkpoint package, the
filesystems, the progress bar, the compactor, the serving API, the int8
tables, the variable store, the config, the CTR models, the data feed and
readers, the native helper's bindings, the multi-table step, the storage
tier, the module adapter and the distributed tier with every public name of
the JAX package's ``parallel`` but its three placement helpers too, the
remote-storage clients and emulators, the profiling helpers, the
examples' twins and the TFPlus bridge) and chip_smoke.py loads neither
JAX, the JAX package, TensorFlow nor protobuf, and needs no nvcc."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import tfplus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tfplus_tpu_torch.__path__,
                                               "tfplus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tfplus_tpu",
                                    "tensorflow")
             or m.startswith("google.protobuf"))
assert not bad, bad
new = {"tfplus_tpu_torch.ops.rowops", "tfplus_tpu_torch.ops.flash_attention",
       "tfplus_tpu_torch.nn.attention", "tfplus_tpu_torch.models.bst",
       "tfplus_tpu_torch.models.din", "tfplus_tpu_torch.optim.rules",
       "tfplus_tpu_torch.optim.base", "tfplus_tpu_torch.optim.dense",
       "tfplus_tpu_torch.train", "tfplus_tpu_torch.checkpoint",
       "tfplus_tpu_torch.checkpoint.bundle", "tfplus_tpu_torch.checkpoint.saver",
       "tfplus_tpu_torch.checkpoint.manager",
       "tfplus_tpu_torch.checkpoint.repartition", "tfplus_tpu_torch.io",
       "tfplus_tpu_torch.io.filesystem", "tfplus_tpu_torch.utils.progress",
       "tfplus_tpu_torch.ops.compactor", "tfplus_tpu_torch.ops.claim",
       "tfplus_tpu_torch.ops.probe",
       "tfplus_tpu_torch.config",
       "tfplus_tpu_torch.kv.quant", "tfplus_tpu_torch.variables",
       "tfplus_tpu_torch.serving", "tfplus_tpu_torch.models.dlrm",
       "tfplus_tpu_torch.models.deepfm", "tfplus_tpu_torch.models.ncf",
       "tfplus_tpu_torch.data", "tfplus_tpu_torch.data.feed",
       "tfplus_tpu_torch.data.criteo", "tfplus_tpu_torch.data.synthetic",
       "tfplus_tpu_torch.data.movielens", "tfplus_tpu_torch.io.native",
       "tfplus_tpu_torch.kv.multi", "tfplus_tpu_torch.kv.storage",
       "tfplus_tpu_torch.models.module_adapter",
       "tfplus_tpu_torch.parallel", "tfplus_tpu_torch.parallel.mesh",
       "tfplus_tpu_torch.parallel.sharded_table",
       "tfplus_tpu_torch.parallel.serving", "tfplus_tpu_torch.parallel.hybrid",
       "tfplus_tpu_torch.parallel.sharded2d",
       "tfplus_tpu_torch.parallel.ring_attention",
       "tfplus_tpu_torch.io.retry", "tfplus_tpu_torch.io.object_store",
       "tfplus_tpu_torch.io.oss_emulator", "tfplus_tpu_torch.io.s3",
       "tfplus_tpu_torch.io.s3_emulator", "tfplus_tpu_torch.io.dfs",
       "tfplus_tpu_torch.io.dfs_emulator",
       "tfplus_tpu_torch.utils.profiling", "tfplus_tpu_torch.examples",
       "tfplus_tpu_torch.examples._common",
       "tfplus_tpu_torch.examples.train_dcn",
       "tfplus_tpu_torch.examples.train_deepfm",
       "tfplus_tpu_torch.examples.train_din",
       "tfplus_tpu_torch.examples.train_ncf",
       "tfplus_tpu_torch.examples.serving_demo",
       "tfplus_tpu_torch.examples.checkpoint_resume",
       "tfplus_tpu_torch.examples.train_dlrm_sharded",
       "tfplus_tpu_torch.checkpoint.tf_bundle",
       "tfplus_tpu_torch.checkpoint.tf_import",
       "tfplus_tpu_torch.checkpoint.tf_export",
       "tfplus_tpu_torch.checkpoint.crc32c",
       "tfplus_tpu_torch.examples.migrate_from_tfplus"}
assert new <= set(names), sorted(new - set(names))
from tfplus_tpu_torch.models import BST, DIN
from tfplus_tpu_torch.nn import flash_attention_layer
from tfplus_tpu_torch.ops import (flash_bwd_dkv, flash_bwd_dq,
                                  flash_bwd_single, flash_fwd,
                                  flash_fwd_single)
from tfplus_tpu_torch.models import make_train_step_scan, grow_if_needed
from tfplus_tpu_torch.optim import SparseOptimizer, ALL_RULES
from tfplus_tpu_torch.train import GroupAdamOptimizer, AdamOptimizer
from tfplus_tpu_torch.checkpoint import (CheckpointManager, UnionReader,
                                         restore, save, save_async)
from tfplus_tpu_torch.io import MemFileSystem, get_filesystem
from tfplus_tpu_torch.kv import export_arrays, grow, grow_to_fit, compact
from tfplus_tpu_torch.ops import compact as compact_rows
from tfplus_tpu_torch.utils.progress import ProgressBar
from tfplus_tpu_torch import get_kv_variable, KvVariableStore
from tfplus_tpu_torch.serving import (export_for_serving, load_for_serving,
                                      refresh_from_delta)
from tfplus_tpu_torch.kv import (scatter, delete_with_timestamp, get_count,
                                 get_timestamp)
from tfplus_tpu_torch.kv.quant import QuantKvTable, lookup_or_zeros
from tfplus_tpu_torch.embedding import (combine, safe_embedding_lookup_sparse,
                                        grads_to_unique)
from tfplus_tpu_torch.models import DLRM, DeepFM, WideDeep, NCF
from tfplus_tpu_torch.data import make_packed_feed
from tfplus_tpu_torch.data.criteo import (BinaryCriteoCache, batches,
                                          build_binary_cache, python_batches)
from tfplus_tpu_torch.data.synthetic import (BehaviorSequence, CriteoLike,
                                             dlrm_batches, movielens_like)
from tfplus_tpu_torch.data.movielens import available, load_or_synthetic
from tfplus_tpu_torch.io.native import (CriteoLoader, crc32, fingerprint64,
                                        fingerprint64_batch,
                                        parse_criteo_batch,
                                        parse_criteo_batch_py)
from tfplus_tpu_torch.kv import (MultiTable, tag_ids, untag_ids_np,
                                 HostStorageTier, HybridTable,
                                 AsyncPrefetcher, spill, prefetch,
                                 export_hybrid_arrays, restore_hybrid_split)
from tfplus_tpu_torch.kv.hashing import (probe_positions, probe_start,
                                         probe_step)
from tfplus_tpu_torch.models import (ModuleSparseModel, init_state_multi,
                                     make_train_step_multi)
from tfplus_tpu_torch.ops import fmha, reference_attention
from tfplus_tpu_torch.convert import (state_from_numpy, sharded_from_numpy,
                                      sharded_2d_from_numpy)
import tfplus_tpu_torch.parallel as par
from tfplus_tpu_torch.parallel import (ShardedHybridTable, ring_attention,
                                       hybrid, mesh, serving, sharded2d,
                                       sharded_table)
from tfplus_tpu_torch.parallel.ring_attention import (
    context_parallel_attention, ring_flash_attention)
from tfplus_tpu_torch.parallel.serving import (
    load_for_serving_sharded, make_serving_lookup, refresh_sharded_from_delta,
    sharded_serving_lookup, stack_shards)
from tfplus_tpu_torch.parallel.mesh import initialize_multihost
from tfplus_tpu_torch.io import (DfsClient, DfsFileSystem, ObjectStoreClient,
                                 OSSFileSystem, S3Client, S3FileSystem,
                                 parse_s3_uri, register_dfs, register_oss,
                                 register_s3)
from tfplus_tpu_torch.io.oss_emulator import OSSEmulator
from tfplus_tpu_torch.io.s3_emulator import S3Emulator
from tfplus_tpu_torch.io.dfs_emulator import DfsEmulator
from tfplus_tpu_torch.io.retry import retry_transient
from tfplus_tpu_torch.utils.profiling import StepMeter, annotate, trace
import tfplus_tpu_torch.utils as tutils
assert tutils.profiling.StepMeter is StepMeter
for twin in ("train_dcn", "train_deepfm", "train_din", "train_ncf",
             "serving_demo", "checkpoint_resume", "train_dlrm_sharded",
             "migrate_from_tfplus"):
    assert callable(importlib.import_module(
        "tfplus_tpu_torch.examples." + twin).main), twin
public = {"ExchangeState", "create_sharded", "dropped_positions",
          "grow_sharded_if_needed", "init_optimizer_sharded", "local_shard",
          "route_stats", "shard_sizes", "sharded_apply_grads",
          "sharded_embedding_lookup_sparse", "sharded_grow",
          "sharded_lookup", "sharded_needs_grow", "COL_AXIS", "ROW_AXIS",
          "combine_col_shards", "create_sharded_2d", "for_col_axis",
          "grow_sharded_2d_if_needed", "init_optimizer_sharded_2d",
          "local_shard_2d", "make_mesh_2d", "shard_sizes_2d",
          "sharded_apply_grads_2d", "sharded_grow_2d", "sharded_lookup_2d",
          "sharded_needs_grow_2d", "TABLE_AXIS", "make_mesh",
          "ShardedHybridTable", "ring_attention", "hybrid", "mesh",
          "serving", "sharded2d", "sharded_table"}
assert public <= set(dir(par)), sorted(public - set(dir(par)))
from tfplus_tpu_torch.checkpoint import (TFBundleReader, TFBundleWriter,
                                         tf_bundle, tf_export, tf_import,
                                         write_bundle)
from tfplus_tpu_torch.checkpoint.tf_import import (
    attach_slot_rows, import_checkpoint, import_kv_variable,
    list_kv_variables, read_dense)
from tfplus_tpu_torch.checkpoint.tf_export import export_checkpoint
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tfplus_tpu",
                                    "tensorflow")
             or m.startswith("google.protobuf"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


BRIDGE = """
import sys
from tfplus_tpu_torch.checkpoint import tf_bundle, tf_export, tf_import
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tfplus_tpu",
                                    "tensorflow")
             or m.startswith("google.protobuf"))
assert not bad, bad
print(sorted(m for m in sys.modules if "tf_" in m))
"""


def test_tf_bridge_imports_no_tensorflow_jax_or_protobuf():
    """The TFPlus bridge reads and writes TensorBundles itself: importing
    it loads neither TensorFlow, JAX, the JAX package nor protobuf."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", BRIDGE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tfplus_tpu_torch.checkpoint.tf_bundle" in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
