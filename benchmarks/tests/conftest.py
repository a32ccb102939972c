"""Fixtures of the benchmark's own tests: the harness on the path, and a
copy of the benchmark's cells cut to a size the CPU runs in seconds (every
width small; the same files, mixes and limits otherwise)."""
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "dcn_criteo": dict(embedding_dims=[8, 16, 8], dnn_hidden=[32, 16],
                       rows_per_table=1 << 11, keys_per_table=1 << 10),
    "bst_taobao": dict(embedding_dim=16, num_heads=2, head_dim=8,
                       ffn_hidden=32, dnn_hidden=[32, 16], seq_len=6,
                       item_rows=1 << 12, item_keys=1 << 11,
                       user_rows=1 << 11, user_keys=1 << 10),
}


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


# plain SGD on the tables and the towers, at MLPerf DLRM's learning rate
SGD = {"sparse_optimizer": {"rule": "sgd", "lr": 1.0},
       "dense_optimizer": {"rule": "sgd", "lr": 1.0}}


def tiny_files(tmp, bench, extra=None):
    """``Files`` over every cell of BENCHMARK.json, under the same names,
    at tiny widths, with ``extra`` (e.g. :data:`SGD`) set in every
    configuration."""
    from benchlib.files import Files
    for d in ("configs", "models", "traffic", "limits"):
        (tmp / d).mkdir()
    for name, cut in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg.update(cut, **(extra or {}))
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for path in (BENCH / "traffic").glob("*.json"):
        m = json.loads(path.read_text())
        m.update(batch=64, pool_batches=4)
        (tmp / "traffic" / path.name).write_text(json.dumps(m))
    return Files(bench, roots=[tmp, BENCH])


@pytest.fixture(scope="session")
def tiny(tmp_path_factory, bench):
    """``(Files, cells)``: every cell of BENCHMARK.json, under the same
    names, at tiny widths."""
    return (tiny_files(tmp_path_factory.mktemp("tiny"), bench),
            {w["name"]: w for w in bench["workloads"]})


@pytest.fixture(scope="session")
def tiny_sgd(tmp_path_factory, bench):
    """As ``tiny``, with plain SGD on the tables and the towers."""
    return (tiny_files(tmp_path_factory.mktemp("tiny_sgd"), bench, SGD),
            {w["name"]: w for w in bench["workloads"]})
