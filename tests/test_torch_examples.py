"""The examples' twins (``tfplus_tpu_torch/examples``) on the CPU at tiny
arguments: each keeps its original's flags, runs through its ``main`` and
passes its own self-checks. ``train_ncf`` and ``train_din`` (DIN) also
run beside their JAX originals on the same arguments: the twin starts
from the original's initial state, and their row counts agree exactly and
their losses within 1e-5 step by step (the tolerance of the training
parity tests: float32 in another summation order). ``checkpoint_resume``
prints its original's lines as the original printed them (that run takes
about 3 minutes of JAX compiles on the CPU). ``migrate_from_tfplus``
prints what its original prints, TensorFlow writing and reading the
original's bundles and the port's own reader and writer the twin's.
``train_dcn`` and
``train_deepfm`` hard-code 26 tables of 2^16 rows (with Adam's slots, over
a GB on the host), so only their shared helpers run here; the card runs
them whole."""
import contextlib
import importlib
import os
import re
import runpy
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tfplus_tpu_torch import convert
from tfplus_tpu_torch.examples import (_common, checkpoint_resume,
                                       migrate_from_tfplus, serving_demo,
                                       train_dcn, train_din, train_ncf)

ROOT = Path(__file__).resolve().parents[1]
TWINS = ["train_dcn", "train_deepfm", "train_din", "train_ncf",
         "serving_demo", "checkpoint_resume", "train_dlrm_sharded",
         "migrate_from_tfplus"]
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
# DIN's eval logits (of order 0.1-0.4) after 50 Adam steps: the dense
# weights and rows drift apart by float32 summation order as the training
# parity tests describe for three steps (~1e-5 there), here up to 2.8e-4
EVAL_TOL = dict(atol=1e-3, rtol=0)


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' tensors here are small: intra-op threads gain nothing,
    and beside the other test workers they contend for the cores (BST's
    twin took minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_original(monkeypatch, name, args):
    """``python examples/<name>.py ARGS`` in this process (its ``sys.path``
    insert undone afterwards)."""
    path = str(ROOT / "examples" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + args)
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(path, run_name="__main__")


def _flags(capsys, run):
    with pytest.raises(SystemExit) as e:
        run()
    assert e.value.code == 0
    return set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)",
                          capsys.readouterr().out))


@pytest.mark.parametrize("name", TWINS)
def test_twin_keeps_the_original_flags(name, monkeypatch, capsys):
    """``--help`` of the JAX example and of its twin list the same
    options (both parse their flags before importing anything heavy)."""
    want = _flags(capsys, lambda: _run_original(monkeypatch, name,
                                                ["--help"]))
    twin = importlib.import_module(f"tfplus_tpu_torch.examples.{name}")
    got = _flags(capsys, lambda: twin.main(["--help"]))
    assert want == got
    assert "--cpu" in got


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_auc_accuracy_against_pairwise_counts():
    rng = np.random.RandomState(0)
    labels = (rng.rand(500) < 0.3).astype(np.float32)
    scores = rng.randn(500) + labels
    acc, auc = _common.auc_accuracy([labels[:200], labels[200:]],
                                    [scores[:200], scores[200:]])
    pos, neg = scores[labels > 0.5], scores[labels <= 0.5]
    assert auc == pytest.approx((pos[:, None] > neg[None, :]).mean(),
                                abs=1e-12)
    assert acc == pytest.approx(((scores > 0) == (labels > 0.5)).mean())
    assert _common.auc_accuracy(np.ones(3), np.arange(3.0))[1] == 0.0


def test_dcn_stream_and_batches(monkeypatch):
    """Without a Criteo file the stream is the planted one of seed 0;
    ``to_batch`` keeps the raw ids; ``host_batch`` encodes them as the
    int32 pairs ``kv.encode_ids`` gives."""
    from tfplus_tpu_torch import kv
    from tfplus_tpu_torch.data import synthetic
    monkeypatch.delenv("CRITEO_PATH", raising=False)
    args = train_dcn.parse_args(["--batch-size", "64", "--train-batches",
                                 "2", "--eval-batches", "1",
                                 "--data", "/nonexistent"])
    monkeypatch.setattr("tfplus_tpu_torch.data.criteo.available",
                        lambda path=None: None)
    tr, ev = train_dcn.criteo_streams(args)
    want = list(synthetic.CriteoLike(seed=0).batches(64, 2))
    got = list(tr)
    assert len(got) == 2 and len(list(ev)) == 1
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    b = got[0]
    tb = train_dcn.to_batch(b)
    assert sorted(tb["ids"]) == sorted(f"C{i}" for i in range(1, 27))
    hb = train_dcn.host_batch(np, b)
    for i in (0, 25):
        np.testing.assert_array_equal(
            hb["ids"][f"C{i+1}"],
            kv.encode_ids(b["categorical"][:, i], device="cpu").numpy())


def test_steps_per_loop_equals_single_steps():
    """The ``--steps-per-loop`` path (K host batches stacked, packed into
    one buffer, unpacked and run by ``make_train_step_scan``) gives the
    single steps' losses and tables bit for bit, on a small DCN."""
    import functools
    from tfplus_tpu_torch import kv, train
    from tfplus_tpu_torch.data import make_packed_feed, synthetic
    from tfplus_tpu_torch.models import (DCN, init_state, make_train_step,
                                         make_train_step_scan)
    model = DCN(embedding_dims=(8, 8), num_numeric=13, dnn_hidden=(8, 4),
                capacity=1 << 10)
    model.table_specs = {f"C{i+1}": dict(dim=8, capacity=1 << 10)
                         for i in range(26)}
    opt = train.GroupAdamOptimizer(learning_rate=1e-3)
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    host = [train_dcn.host_batch(np, b) for b in
            synthetic.CriteoLike(seed=0).batches(32, 4)]
    a = init_state(model, opt, tx, seed=0, device="cpu")
    b = init_state(model, opt, tx, seed=0, device="cpu")
    step = make_train_step(model, opt, sparse_lr=1e-3)
    single = []
    for hb in host:
        a, loss, _ = step(a, hb)
        single.append(loss)
    scan = make_train_step_scan(model, opt, sparse_lr=1e-3)
    losses = []
    for k in (0, 2):
        stacked = train_dcn.stack_batches(np, host[k:k + 2])
        pack, unpack = make_packed_feed(stacked, device="cpu")
        b, ls = scan(b, unpack(pack(stacked)))
        losses.extend(ls)
    assert all(torch.equal(x, y) for x, y in zip(single, losses))
    for n in a.tables:
        assert torch.equal(a.tables[n].payload, b.tables[n].payload)
        assert torch.equal(a.tables[n].header, b.tables[n].header)
    assert int(kv.size(a.tables["C1"])) > 0


@contextlib.contextmanager
def _recorded(monkeypatch, rec, jax_side):
    """Inside the block the JAX package's (``jax_side``) or the port's
    ``models.init_state`` and ``make_train_step`` are wrapped: the JAX
    example's initial state goes to ``rec["state"]``, the twin starts from
    it, and each training step's loss is appended to ``rec["losses"]``
    and each eval step's predictions to ``rec["preds"]`` (both emptied
    first)."""
    if jax_side:
        from tfplus_tpu import models
    else:
        from tfplus_tpu_torch import models
    rec["losses"], rec["preds"] = [], []
    init, make = models.init_state, models.make_train_step

    def init_state(model, opt, tx, seed=0, **kw):
        if not jax_side:
            return convert.state_from_numpy(rec["state"], model, tx, "cpu")
        state = init(model, opt, tx, seed=seed, **kw)
        rec["state"] = jax.device_get(state)       # before any donation
        return state

    def make_train_step(*a, **kw):
        step = make(*a, **kw)
        key = "losses" if kw.get("train", True) else "preds"

        def recorded(state, batch):
            state, loss, preds = step(state, batch)
            rec[key].append(np.asarray(loss) if key == "losses" else
                            np.asarray(preds, np.float32))
            return state, loss, preds
        return recorded

    with monkeypatch.context() as m:
        m.setattr(models, "init_state", init_state)
        m.setattr(models, "make_train_step", make_train_step)
        yield


def _same_lines(want, got, pattern):
    """The printed lines of ``want`` and ``got`` that match ``pattern``,
    pairwise, the examples/s figures left out: equal integers, and decimals
    within ``LOSS_TOL`` of each other plus the rounding of two prints to
    five places."""
    def lines(text):
        return [re.sub(r"\([^)]*/s\)", "", x) for x in text.splitlines()
                if re.search(pattern, x)]
    a, b = lines(want), lines(got)
    assert len(a) == len(b) > 0, (a, b)
    for x, y in zip(a, b):
        tx, ty = (re.findall(r"-?\d+(?:\.\d+)?", z) for z in (x, y))
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            if "." in u or "." in v:
                assert abs(float(u) - float(v)) <= (
                    2e-5 + 1e-5 * abs(float(u))), (x, y)
            else:
                assert u == v, (x, y)


def test_ncf_twin_loss_falls(tmp_path, monkeypatch, capsys):
    """The twin and ``examples/train_ncf.py`` on one tiny run: the same
    loss at every step (within 1e-5), the same printed epoch losses and row
    counts, and the loss falls."""
    args = ["--cpu", "--epochs", "3", "--examples", "1024",
            "--batch-size", "128"]
    jrec, trec = {}, {}
    with _recorded(monkeypatch, jrec, True):
        _run_original(monkeypatch, "train_ncf", args)
    want = capsys.readouterr().out
    trec["state"] = jrec["state"]
    with _recorded(monkeypatch, trec, False):
        out = train_ncf.main(args + ["--ckpt-dir", str(tmp_path / "ck")])
    got = capsys.readouterr().out
    assert len(trec["losses"]) == len(jrec["losses"]) == 24
    np.testing.assert_allclose(trec["losses"], jrec["losses"], **LOSS_TOL)
    _same_lines(want, got, r"^epoch: ")
    rows = re.search(r"user rows: (\d+) movie rows: (\d+)", want).groups()
    assert (out["user_rows"], out["movie_rows"]) == tuple(map(int, rows))
    assert out["losses"][-1] < out["losses"][0]
    assert (tmp_path / "ck").exists()


@pytest.mark.parametrize("model,batches", [("din", 50), ("bst", 10)])
def test_din_twin(model, batches, monkeypatch, capsys):
    """DIN to its first printed loss (step 50) beside
    ``examples/train_din.py``: the same loss at every step, eval
    predictions within ``EVAL_TOL``, the same printed loss and row
    counts. The printed AUC is left out: on 128 eval examples one pair of
    near-equal scores that swaps moves it by 2.5e-4. BST, whose plain
    flash attention is slow on the CPU, for 10 steps on its own (its
    parity is the training and attention tests')."""
    args = ["--cpu", "--model", model, "--train-batches", str(batches),
            "--batch-size", "64", "--eval-batches", "2"]
    if model == "din":
        jrec, trec = {}, {}
        with _recorded(monkeypatch, jrec, True):
            _run_original(monkeypatch, "train_din", args)
        want = capsys.readouterr().out
        trec["state"] = jrec["state"]
        with _recorded(monkeypatch, trec, False):
            out = train_din.main(args)
        got = capsys.readouterr().out
        assert len(trec["losses"]) == len(jrec["losses"]) == batches
        np.testing.assert_allclose(trec["losses"], jrec["losses"],
                                   **LOSS_TOL)
        assert len(trec["preds"]) == len(jrec["preds"]) == 2
        np.testing.assert_allclose(np.concatenate(trec["preds"]),
                                   np.concatenate(jrec["preds"]), **EVAL_TOL)
        _same_lines(want, got, r"^(step \d+ loss|item rows)")
    else:
        out = train_din.main(args)
    assert np.isfinite(out["losses"]).all()
    assert len(out["losses"]) == batches // 50
    assert 0.0 <= out["auc"] <= 1.0 and out["examples_per_s"] > 0
    assert out["item_rows"] > 1000 and out["user_rows"] > 300


@pytest.mark.parametrize("flags", [[], ["--quantize"],
                                   ["--sharded", "--quantize"]],
                         ids=["f32", "int8", "sharded-int8"])
def test_serving_demo_self_test(flags):
    out = serving_demo.main(["--cpu", "--port", str(_free_port())] + flags)
    assert out["max_abs_err"] <= out["tolerance"]
    assert out["signature"]["user"]["embedding_dim"] == 16
    if not flags:
        assert out["max_abs_err"] == 0.0


# what ``python examples/checkpoint_resume.py --cpu`` prints (the JAX
# package's eager table ops compile for each shard's shape: the run takes
# about 3 minutes on the CPU, too long to repeat in every test run)
CHECKPOINT_RESUME_OUT = """\
[train] 4 shards, 30 steps, 3933 rows; full@20 + deltas@25,@30 saved
[restore] resumed at step 30 into 6 shards — 64-id sample matches \
bit-for-bit after 4→6 repartition
[resume] trained 5 more steps on 6 shards; rows 4179
OK
"""


def test_checkpoint_resume_twin(capsys):
    """The twin prints what ``examples/checkpoint_resume.py`` prints, line
    for line: the same row counts before and after the 4 -> 6 restore (the
    id stream and the tables' hashing are shared; the rows' values start
    from each package's own init pools) and the same step."""
    out = checkpoint_resume.main(["--cpu"])
    assert capsys.readouterr().out == CHECKPOINT_RESUME_OUT
    assert out == {"step": 30, "rows_before": 3933, "rows_after": 4179}


def test_migration_twin_prints_the_originals_lines(monkeypatch, capsys):
    """``examples/migrate_from_tfplus.py --cpu`` (TensorFlow writes and
    reads its bundles) and the twin (the port's own bundle reader and
    writer): the same discovered shards and rows, imported rows, dense
    shape and exported tensor names, line for line (the first line names
    each run's temporary directory)."""
    pytest.importorskip("tensorflow")
    _run_original(monkeypatch, "migrate_from_tfplus", ["--cpu"])
    want = capsys.readouterr().out
    out = migrate_from_tfplus.main(["--cpu"])
    got = capsys.readouterr().out

    def lines(text):
        return [x for x in text.splitlines() if not x.startswith("[1]")]
    assert lines(got) == lines(want)
    assert len(lines(got)) == 5
    assert out["discovered_shards"] == {"user_emb": 2}
    assert out["imported_rows"] == 2000
    # the training steps' ids are all in the checkpoint: no new rows
    assert out["rows_per_shard"] == [667, 667, 666]
    assert len(out["exported_tensors"]) == 19


def test_dlrm_sharded_twin_on_two_gloo_ranks():
    """One torchrun launch of two gloo ranks with a 16-id exchange bucket:
    the route-overflow recovery retries the dropped ids, the tables grow,
    and the elastic 2 -> 4 restore keeps every row."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "2", "--master-port", str(_free_port()),
           "-m", "tfplus_tpu_torch.examples.train_dlrm_sharded", "--cpu",
           "--batches", "20", "--batch-size", "256", "--tables", "3",
           "--capacity", "256", "--bucket-capacity", "16"]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    text = out.stdout
    assert "mesh: 2 x cpu, batch 256" in text
    assert "exchange-bucket overflow" in text
    assert "grew tables to per-shard capacity" in text
    assert "elastic restore 2 -> 4 shards: row counts match" in text
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", text)]
    assert len(losses) == 2 and np.isfinite(losses).all()
