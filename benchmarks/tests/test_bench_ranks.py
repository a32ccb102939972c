"""A cell over several ranks, one process per card: a tiny DCN cell whose
adapter (``sharded_dcn.py``) steps over row-sharded tables, from a test
root, through the launcher over 2 gloo ranks on the CPU (``-m cuda``: over
NCCL on up to 4 cards), with Adam's rules and with plain SGD; and
``readings.py`` over the same ranks. Each launch has a limit of 100 s and
each collective one of 60 s, so that a hung rank fails the test instead of
eating the suite's time. Also: a one-card cell starts no process and joins
no group, and the rows of a configuration without ``row_draw`` are the
whole-table draw they always were."""
import importlib.util
import json
import subprocess
import time

import pytest
import torch
import torch.distributed as dist

from benchlib import inputs, ranks, result, runner
from benchlib.files import Files
from benchlib.program import SparseProgram

from conftest import BENCH, SGD, TINY

LIMIT_S = 100
COLLECTIVE_S = 60
SEED = 2 ** 31 + 77
SECONDS = 0.5
# configuration -> (the adapter's FAULT, what the configuration sets)
CONFIGS = {"dcn_sharded": (None, {}),
           "dcn_sharded_fault": ("scale_rank1", {}),
           "dcn_sharded_dies": ("rank1_exits", {}),
           "dcn_sharded_sgd": (None, SGD)}
TRAIN_METRICS = ("train_examples_per_s", "setup_s")


def _cell(config, chips):
    return {"name": f"{config}.chips{chips}", "config": config,
            "traffic": "train_zipf", "chips": chips, "why": "test"}


def _root(tmp, bench, cells, cut=None, mix_cut=None, limits=None):
    """A test root with the sharded configurations (``cut`` in place of the
    tiny widths' table sizes and more), the tiny training mix (with
    ``mix_cut``) and the DCN training limits (or ``limits``); returns its
    ``Files`` over ``cells``."""
    for d in ("configs", "models", "traffic", "limits"):
        (tmp / d).mkdir()
    base = json.loads((BENCH / "configs" / "dcn_criteo.json").read_text())
    base.update(TINY["dcn_criteo"] if cut is None else cut,
                row_draw="chunked")
    adapter = (BENCH / "tests" / "sharded_dcn.py").read_text()
    for name, (fault, extra) in CONFIGS.items():
        cfg = dict(base, **extra)
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (tmp / "models" / f"{name}.py").write_text(
            adapter + f"\nFAULT = {fault!r}\n")
    mix = json.loads((BENCH / "traffic" / "train_zipf.json").read_text())
    mix.update(mix_cut or dict(batch=64, pool_batches=4))
    (tmp / "traffic" / "train_zipf.json").write_text(json.dumps(mix))
    text = (json.dumps(limits) if limits is not None else
            (BENCH / "limits" / "dcn_criteo.train_zipf.json").read_text())
    for c in cells:
        (tmp / "limits" / f"{c['name']}.json").write_text(text)
    names = [c["name"] for c in cells]
    test_bench = {
        "workloads": cells,
        "end_to_end": [dict(m, workloads=names) for m in bench["end_to_end"]
                       if m["name"] in TRAIN_METRICS],
        "per_layer": [dict(m, workloads=names) for m in bench["per_layer"]
                      if m["moves"] == "train_examples_per_s"
                      and "flash" not in m["name"]]}
    return Files(test_bench, roots=[tmp, BENCH])


CELLS = [_cell("dcn_sharded", 1), _cell("dcn_sharded", 2),
         _cell("dcn_sharded_fault", 2), _cell("dcn_sharded_dies", 2),
         _cell("dcn_sharded_sgd", 1), _cell("dcn_sharded_sgd", 2)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, bench):
    return _root(tmp_path_factory.mktemp("sharded"), bench, CELLS)


@pytest.fixture(scope="module")
def run_py():
    """``run.py`` as a module (its import sets the run's environment, which
    is put back afterwards)."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TRITON_CACHE_DIR", "OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            mp.delenv(var, raising=False)
        spec = importlib.util.spec_from_file_location("bench_run_py",
                                                      BENCH / "run.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod


def _pretend_cards(mp, n):
    mp.setattr(torch.cuda, "is_available", lambda: True)
    mp.setattr(torch.cuda, "device_count", lambda: n)
    mp.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")


def _argv(cell, trace=0):
    return ["--workload", cell["name"], "--seed", str(SEED), "--seconds",
            str(SECONDS), "--trace", str(trace)]


def _lines(capfd):
    out, err = capfd.readouterr()
    return [json.loads(x) for x in out.splitlines() if x.strip()], err


def _launch(files, cell, capfd, trace=False, device="cpu"):
    t0 = time.perf_counter()
    rc = ranks.run(files, cell, SEED, SECONDS, trace, t0, device,
                   limit_s=LIMIT_S, collective_s=COLLECTIVE_S)
    lines, err = _lines(capfd)
    return rc, lines, err, time.perf_counter() - t0


@pytest.fixture(scope="module")
def one_rank(sharded, run_py):
    """The 1-rank line of the sharded configuration, through ``run.py``'s
    own path, with any child process or process group made to fail."""
    def refuse(*a, **k):
        raise AssertionError("a one-card cell started a process or a group")

    with pytest.MonkeyPatch.context() as mp:
        _pretend_cards(mp, 1)
        mp.setattr(subprocess, "Popen", refuse)
        mp.setattr(dist, "init_process_group", refuse)
        mp.setattr(dist, "new_group", refuse)
        out = []
        mp.setattr(result, "emit", lambda line: out.append(line))
        rc = run_py.main(_argv(CELLS[0]), cells=sharded, device="cpu")
    return rc, out, dist.is_initialized()


def test_a_one_card_cell_starts_no_process_and_joins_no_group(one_rank):
    rc, out, joined = one_rank
    assert rc == 0 and len(out) == 1 and not joined
    assert out[0]["correct"] is True, out[0]["checks"]
    assert out[0]["device"]["count"] == 1


def test_two_ranks_print_one_correct_line_with_the_one_rank_checks(
        sharded, one_rank, capfd):
    rc, lines, err, took = _launch(sharded, CELLS[1], capfd)
    assert rc == 0, err[-4000:]
    assert len(lines) == 1 and took < LIMIT_S
    line = lines[0]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == set(TRAIN_METRICS)
    one = one_rank[1][0]
    assert line["correct"] == one["correct"]
    assert set(line["checks"]) == set(one["checks"])
    for k, c in line["checks"].items():
        # the same numbers but for the order of the exchange's sums
        assert c["value"] == pytest.approx(one["checks"][k]["value"],
                                           abs=1e-6), k
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_the_traced_two_rank_line(sharded, capfd):
    """(On the CPU the trace holds no device work, so the readers find
    nothing to read: the ``-m cuda`` test reads them.)"""
    rc, lines, err, _ = _launch(sharded, CELLS[1], capfd, trace=True)
    assert rc == 0, err[-4000:]
    assert len(lines) == 1 and lines[0]["correct"] is True
    dev = lines[0]["device"]
    assert dev["count"] == 2 and dev["window_s"] > 0 and "busy_s" in dev
    assert set(lines[0]["metrics"]) <= set(sharded.readers(CELLS[1]))
    assert set(lines[0]["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_fault_in_rank_1s_shard_is_not_correct(sharded, capfd):
    rc, lines, err, _ = _launch(sharded, CELLS[2], capfd)
    assert rc == 0, err[-4000:]
    assert len(lines) == 1 and lines[0]["correct"] is False


def test_a_rank_that_exits_early_fails_the_launch_with_no_line(sharded,
                                                               capfd):
    rc, lines, err, took = _launch(sharded, CELLS[3], capfd)
    assert rc != 0 and lines == [] and took < LIMIT_S + 10
    assert "no result" in err


def test_run_py_hands_a_multi_card_cell_to_the_launcher(sharded, run_py):
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _pretend_cards(mp, 2)
        mp.setattr(ranks, "run", lambda *a: seen.append(a) or 0)
        assert run_py.main(_argv(CELLS[1]), cells=sharded, device="cpu") == 0
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        assert run_py.main(_argv(CELLS[1]), cells=sharded,
                           device="cpu") == 2
    assert len(seen) == 1 and seen[0][1] is sharded.cell(CELLS[1]["name"])


def test_a_table_without_row_draw_holds_the_whole_table_draw(tiny):
    files, _ = tiny
    cfg = files.config("dcn_criteo")
    assert "row_draw" not in cfg
    prog = SparseProgram(files.model("dcn_criteo"), cfg,
                         files.traffic("train_zipf"), 5, "cpu")
    for name, (dim, _, n) in prog.tables.items():
        ids = inputs.key_of(torch.arange(n), 5, name).numpy()
        held = prog._rows(name, ids, 0, dim)
        assert torch.equal(held, inputs.table_rows(5, name, n, dim, "cpu"))
    # the whole-table draw itself, as the first benchmark drew it
    rows = inputs.table_rows(3, "C1", 4, 2, "cpu")
    g = torch.Generator("cpu").manual_seed(inputs.derive(3, "rows", "C1"))
    assert torch.equal(rows, torch.randn((4, 2), generator=g) * 0.05)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_chunked_rows_are_the_same_over_any_number_of_ranks(monkeypatch,
                                                            world):
    """Each rank draws its ids' rows chunk by chunk; together they are the
    rows that ``rows_at`` draws for any ids, and no chunk depends on the
    number of ranks."""
    monkeypatch.setattr(inputs, "ROW_CHUNK", 64)
    n, dim = 300, 4
    whole = torch.cat([inputs.chunk_rows(9, "t", c, n, dim, "cpu")
                       for c in range(5)])
    assert whole.shape == (n, dim)
    idx = torch.arange(n)
    got = torch.empty_like(whole)
    for r in range(world):
        mine = idx[idx % world == r]
        got[mine] = inputs.rows_at(9, "t", mine, n, dim, "cpu")
    assert torch.equal(got, whole)
    pick = torch.tensor([299, 0, 130, 64, 63])
    assert torch.equal(inputs.rows_at(9, "t", pick, n, dim, "cpu"),
                       whole[pick])


def test_a_chunked_one_card_run_is_correct(sharded, monkeypatch):
    """The fill and the reference draw a chunked table's rows alike across
    several chunks (chunks cut small here)."""
    monkeypatch.setattr(inputs, "ROW_CHUNK", 256)
    out = runner.run(sharded, CELLS[0], SEED, 0.2, False, "cpu", 0.0)
    assert out["correct"] is True, out["checks"]


@pytest.mark.cuda
def test_the_sharded_cell_over_nccl(tmp_path, bench, capfd):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    cell = _cell("dcn_sharded", min(torch.cuda.device_count(), 4))
    files = _root(tmp_path, bench, [cell])
    for trace in (False, True):
        rc, lines, err, _ = _launch(files, cell, capfd, trace, "cuda")
        assert rc == 0, err[-4000:]
        assert len(lines) == 1 and lines[0]["correct"] is True, lines
        assert lines[0]["device"]["count"] == cell["chips"]
        assert lines[0]["device"]["memory_peak_bytes"] > 0
        if trace:
            assert lines[0]["device"]["busy_s"] > 0
            assert "launches_per_step.train" in lines[0]["metrics"]


def test_two_ranks_with_sgd_print_one_correct_line_with_the_one_rank_checks(
        sharded, capfd):
    """The sharded adapter with plain SGD on the tables and the towers."""
    one = runner.run(sharded, CELLS[4], SEED, SECONDS, False, "cpu", 0.0)
    assert one["correct"] is True, one["checks"]
    rc, lines, err, _ = _launch(sharded, CELLS[5], capfd)
    assert rc == 0, err[-4000:]
    assert len(lines) == 1 and lines[0]["correct"] is True, lines
    for k, c in lines[0]["checks"].items():
        assert c["value"] == pytest.approx(one["checks"][k]["value"],
                                           abs=1e-6), k


def _readings(files, cell, seeds, capfd, device="cpu"):
    import readings
    rc = readings.main(["--workload", cell["name"], "--seeds",
                        *map(str, seeds), "--device", device], files=files,
                       limit_s=LIMIT_S, collective_s=COLLECTIVE_S)
    lines, err = _lines(capfd)
    return rc, lines, err


@pytest.mark.parametrize("cell", [CELLS[1], CELLS[5]],
                         ids=lambda c: c["config"])
def test_readings_over_two_ranks_print_a_line_a_seed_with_the_runs_checks(
        sharded, cell, capfd):
    rc, lines, err = _readings(sharded, cell, [SEED, SEED + 1], capfd)
    assert rc == 0, err[-4000:]
    assert [x["seed"] for x in lines] == [SEED, SEED + 1]
    for x in lines:
        assert {"program", "reference_f32", "control_tf32",
                "fault_half_batch", "missing_ids", "fill_unplaced",
                "losses"} <= set(x)
        assert x["missing_ids"] == {}
    rc, run_lines, err, _ = _launch(sharded, cell, capfd)
    assert rc == 0 and len(run_lines) == 1, err[-4000:]
    for k, c in run_lines[0]["checks"].items():
        assert lines[0]["program"][k] == c["value"], k


def test_readings_with_a_rank_that_exits_early_print_no_line(sharded,
                                                              capfd):
    t0 = time.perf_counter()
    rc, lines, err = _readings(sharded, CELLS[3], [SEED], capfd)
    assert rc != 0 and lines == [] and "no result" in err
    assert time.perf_counter() - t0 < LIMIT_S + 10


@pytest.mark.cuda
def test_readings_over_nccl(tmp_path, bench, capfd):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    cell = _cell("dcn_sharded_sgd", min(torch.cuda.device_count(), 4))
    files = _root(tmp_path, bench, [cell])
    limits = files.limits(cell["name"])
    rc, lines, err = _readings(files, cell, [SEED, SEED + 1], capfd, "cuda")
    assert rc == 0, err[-4000:]
    assert [x["seed"] for x in lines] == [SEED, SEED + 1]
    for x in lines:
        assert all(x["program"][k] <= v for k, v in limits.items()), x
        assert x["missing_ids"] == {}


def test_readings_of_a_one_card_cell_start_no_process(tiny, capfd):
    """A one-card cell's readings stay in this process, and its program
    numbers are the run's own check numbers for the seed."""
    files, cells = tiny
    cell = cells["dcn_criteo.train_zipf"]

    def refuse(*a, **k):
        raise AssertionError("a one-card cell started a process or a group")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "Popen", refuse)
        mp.setattr(dist, "init_process_group", refuse)
        rc, lines, err = _readings(files, cell, [SEED], capfd)
    assert rc == 0 and len(lines) == 1, err[-4000:]
    out = runner.run(files, cell, SEED, SECONDS, False, "cpu", 0.0)
    for k, c in out["checks"].items():
        assert lines[0]["program"][k] == c["value"], k
