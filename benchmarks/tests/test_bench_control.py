"""The control on the card: the reference computed in float32 with TF32
products, put in the program's place, has to fail one of each cell's
numbers; the program itself has to pass them. At every width of the cells,
with their tables cut to 2^14 rows (the cells' own sizes are read with
``readings.py`` on the chip, PERF.md)."""
import json

import pytest

from conftest import BENCH, ROOT

CUT = {"dcn_criteo": {"rows_per_table": 1 << 14, "keys_per_table": 1 << 12},
       "bst_taobao": {"item_rows": 1 << 14, "item_keys": 1 << 12,
                      "user_rows": 1 << 14, "user_keys": 1 << 12}}


def _cells():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_the_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import readings
    from benchlib.files import Files
    with open(ROOT / "BENCHMARK.json") as f:
        files = Files(json.load(f))
    w = files.cell(cell)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    for seed in (1, 2, 3):
        out = readings.readings(files, w, seed, CUT[w["config"]], "cuda")
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control_tf32"][k] > v for k, v in limits.items()), \
            out
