"""BENCHMARK.json against the contract's shape, and the harness finding a
configuration, a traffic mix and a per-layer metric by name: the ones
there, and new ones added as files alone from a temporary directory."""
import json
import re

import pytest

from benchlib import runner
from benchlib.files import Files

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_benchmark_json_has_the_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmarks"]
    assert bench["command"][1] == "benchmarks/run.py"
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"benchmarks/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (BENCH / "models" / f"{w['config']}.py").is_file()
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    files = Files(bench)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in files.end_to_end(w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        readers = files.readers(w)
        assert readers
        for m in bench["per_layer"]:
            if m["name"] in readers:
                assert m["moves"] in e2e


def test_found_by_name(bench):
    files = Files(bench)
    for w in bench["workloads"]:
        assert files.config(w["config"])["family"] in ("dcn", "bst")
        assert files.traffic(w["traffic"])["loop"] in ("train", "serve")
        assert hasattr(files.model(w["config"]), "draw")
        for unit, reader in files.readers(w).values():
            assert callable(reader.read) and UNIT.match(unit)
    with pytest.raises(FileNotFoundError):
        files.traffic("no_such_mix")


def test_a_config_a_mix_and_a_metric_added_as_files_alone(tmp_path, tiny):
    """A new configuration (a DCN of other widths, with its adapter), a new
    mix (uniform ids: a Zipf exponent of 0) and a new per-layer metric,
    each a new file under a temporary root; the harness runs the new cell
    on the CPU and reports the new metric from the trace."""
    files, _ = tiny
    for d in ("configs", "models", "traffic", "metrics", "limits"):
        (tmp_path / d).mkdir()
    cfg = files.config("dcn_criteo")
    cfg.update(embedding_dims=[4, 4], dnn_hidden=[8])
    (tmp_path / "configs" / "dcn_small.json").write_text(json.dumps(cfg))
    (tmp_path / "models" / "dcn_small.py").write_text(
        (BENCH / "models" / "dcn_criteo.py").read_text())
    mix = files.traffic("train_zipf")
    mix.update(zipf_s=0.0)
    (tmp_path / "traffic" / "train_uniform.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "host_ops_per_step.train.py").write_text(
        "def read(view):\n"
        "    n = sum(len(v) for v in view.trace.host.values())\n"
        "    return n / view.steps if view.kind == 'train' else None\n")
    cell = {"name": "dcn_small.train_uniform", "config": "dcn_small",
            "traffic": "train_uniform", "chips": 1, "why": "-"}
    (tmp_path / "limits" / f"{cell['name']}.json").write_text(
        (BENCH / "limits" / "dcn_criteo.train_zipf.json").read_text())
    bench = {"workloads": [cell], "end_to_end": [
        {"name": "train_examples_per_s", "unit": "examples/s",
         "better": "higher", "bound": 0.05, "source": "host_clock"}],
        "per_layer": [{"name": "host_ops_per_step.train", "unit": "ops",
                       "better": "lower", "source": "device_trace",
                       "layer": "train / serve step",
                       "moves": "train_examples_per_s"}]}
    new = Files(bench, roots=[tmp_path, files.roots[0], BENCH])
    out = runner.run(new, cell, 2 ** 32 + 5, 0.3, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["host_ops_per_step.train"]["value"] > 0
