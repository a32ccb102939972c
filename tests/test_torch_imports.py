"""The port stands alone: importing tfplus_tpu_torch, every submodule
(the optimizer suite, the training step, the checkpoint package, the
filesystems, the progress bar and the compactor too) and chip_smoke.py
loads neither JAX nor the JAX package, and needs no nvcc."""
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
             if m.split(".")[0] in ("jax", "jaxlib", "tfplus_tpu"))
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
       "tfplus_tpu_torch.ops.compactor"}
assert new <= set(names), sorted(new - set(names))
from tfplus_tpu_torch.models import BST, DIN
from tfplus_tpu_torch.nn import flash_attention_layer
from tfplus_tpu_torch.ops import (flash_bwd_dkv, flash_bwd_dq, flash_fwd,
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
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


def test_chip_smoke_refuses_to_run_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
