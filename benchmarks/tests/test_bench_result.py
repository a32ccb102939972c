"""The last line's keys, the check for JAX and the JAX package by whole
top-level names, and a measurement path that fails without a card."""
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchlib import result, runner

from conftest import BENCH, ROOT


def test_forbidden_modules_compare_whole_top_level_names():
    assert result.forbidden_modules(
        ["tfplus_tpu_torch", "tfplus_tpu_torch.kv", "jaxtyping", "flaxx",
         "numpy"]) == []
    assert result.forbidden_modules(
        ["tfplus_tpu", "tfplus_tpu.kv.table", "jax", "jax.numpy", "jaxlib",
         "flax.linen", "torch"]) == ["flax.linen", "jax", "jax.numpy",
                                     "jaxlib", "tfplus_tpu",
                                     "tfplus_tpu.kv.table"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    files, cells = tiny
    before = set(sys.modules)
    runner.run(files, cells["dcn_criteo.serve_zipf"], 3, 0.2, False,
               "cpu", 0.0)
    assert result.forbidden_modules(set(sys.modules) - before) == []


def test_the_last_line_has_the_contract_keys_and_checks_last(tiny):
    files, cells = tiny
    for trace in (False, True):
        out = runner.run(files, cells["bst_taobao.serve_zipf"], 4,
                         0.2, trace, "cpu", 0.0)
        dev = {"platform": "gpu", "kind": "x", "count": 1,
               "memory_peak_bytes": 0}
        err, std = io.StringIO(), io.StringIO()
        result.emit(result.line(out, dev), err, std)
        line = json.loads(std.getvalue().strip().splitlines()[-1])
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown"] if trace else []
        assert list(line) == keys + ["checks"]
        assert set(line["checks"]) == {"pred"}
        last = err.getvalue().strip().splitlines()[-1]
        assert last.startswith("check pred ") and " limit " in last
        if not trace:
            assert set(line["metrics"]) == {"serve_examples_per_s",
                                            "serve_p95_ms", "setup_s"}
            assert all(set(m) == {"value", "unit"}
                       for m in line["metrics"].values())


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "dcn_criteo.serve_zipf", "--seed", str(2 ** 33 + 1),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_the_run_fails_and_prints_no_result():
    """The measurement path asks for CUDA devices and never falls back to
    the CPU: here, with none, it exits with 2 and prints nothing on
    standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA device" in r.stderr


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
