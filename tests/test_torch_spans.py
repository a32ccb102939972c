"""The port's spans and counters (``utils/profiling``): the span tree of a
training step and a serving request, the gate that keeps spans off without
a profiler, and the counters of the lookup and the claim insert, on an
overflowing table too."""
import functools
import glob
import json
import threading

import numpy as np
import pytest
import torch

from tfplus_tpu_torch import embedding, kv, models, train
from tfplus_tpu_torch.kv import hashing
from tfplus_tpu_torch.ops import claim, probe
from tfplus_tpu_torch.utils import profiling

TABLES = ("C1", "C2", "C3")
#: the span each span nests in (None: the outermost)
PARENTS = {
    "tfp::step": {None},
    "tfp::lookup": {"tfp::step"},
    "tfp::feed": {"tfp::lookup", "tfp::forward"},
    "tfp::dedup": {"tfp::lookup"},
    "tfp::probe": {"tfp::lookup"},
    "tfp::insert": {"tfp::lookup"},
    "tfp::claim_round": {"tfp::insert"},
    "tfp::gather": {"tfp::lookup"},
    "tfp::forward": {"tfp::step"},
    "tfp::backward": {"tfp::step"},
    "tfp::dense_opt": {"tfp::step"},
    "tfp::sparse_opt": {"tfp::step"},
}


def _dcn():
    return models.DCN(embedding_dims=(8, 16, 8), num_numeric=4,
                      dnn_hidden=(32, 16), capacity=1024)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"ids": {n: rng.randint(0, 500, 64) for n in TABLES},
            "features": rng.randn(64, 4).astype(np.float32),
            "labels": rng.randint(0, 2, 64).astype(np.float32)}


def _state_and_step(kind):
    model, opt = _dcn(), train.GroupAdamOptimizer()
    state = models.init_state(model, opt,
                              functools.partial(torch.optim.Adam, lr=1e-2),
                              seed=2, device="cpu")
    if kind == "train":
        return state, models.make_train_step(model, opt, sparse_lr=0.05)
    # the serving request reads tables a training step filled
    state, _, _ = models.make_train_step(model, opt, sparse_lr=0.05)(
        state, _batch(1))
    return state, models.make_train_step(model, train=False)


def _spans(log_dir):
    files = glob.glob(f"{log_dir}/*.pt.trace.json")
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("tfp::")]


def _parents(spans):
    """Each span's innermost enclosing span on its thread (by name)."""
    spans = sorted(spans, key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    out, stack = [], []
    for e in spans:
        while stack and (stack[-1]["tid"] != e["tid"]
                         or stack[-1]["ts"] + stack[-1]["dur"]
                         < e["ts"] + e["dur"] - 1e-3):
            stack.pop()
        out.append((e["name"], stack[-1]["name"] if stack else None))
        stack.append(e)
    return out


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_step_spans_nest_as_the_layers(tmp_path, kind):
    """One step or request under ``profiling.trace``: one ``tfp::step``,
    one lookup a table, one sparse apply a table in training, each span in
    its parent, and as many claim-round spans as the counter counted."""
    state, step = _state_and_step(kind)
    before = profiling.counters()
    with profiling.trace(str(tmp_path)):
        step(state, _batch(2))
    after = profiling.counters()
    spans = _spans(tmp_path)
    names = [e["name"] for e in spans]
    assert names.count("tfp::step") == 1
    assert names.count("tfp::lookup") == len(TABLES)
    assert names.count("tfp::dedup") == len(TABLES)
    assert names.count("tfp::probe") == len(TABLES)
    assert names.count("tfp::gather") == len(TABLES)
    assert names.count("tfp::forward") == 1
    want = {"train": len(TABLES), "serve": 0}[kind]
    assert names.count("tfp::sparse_opt") == want
    assert names.count("tfp::backward") == names.count("tfp::dense_opt") \
        == (1 if kind == "train" else 0)
    # a fresh batch of 64 ids over 500 misses in every table when training
    assert names.count("tfp::insert") == want
    assert names.count("tfp::claim_round") \
        == after["claim_rounds"] - before["claim_rounds"]
    assert (after["claim_rounds"] > before["claim_rounds"]) == (
        kind == "train")
    assert after["lookups"] - before["lookups"] == len(TABLES)
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)


def test_spans_are_off_without_a_profiler(monkeypatch):
    """``annotate`` opens no range while no profiler records, and one per
    span while one does."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    state, step = _state_and_step("train")
    step(state, _batch(2))
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, _batch(3))
    assert opened.count("tfp::step") == 1
    assert all(n.startswith("tfp::") for n in opened)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_traced_step_is_bit_identical(tmp_path, kind):
    """The same step from the same state, with and without a profiler:
    the loss, the predictions, the tables' headers and payloads and the
    dense parameters are equal bit for bit."""
    out = []
    for traced in (False, True):
        state, step = _state_and_step(kind)
        if traced:
            with profiling.trace(str(tmp_path)):
                state, loss, preds = step(state, _batch(2))
        else:
            state, loss, preds = step(state, _batch(2))
        out.append((loss, preds,
                    [(t.header, t.payload) for t in state.tables.values()],
                    [p.detach() for p in state.dense.parameters()]))
    (l0, p0, t0, d0), (l1, p1, t1, d1) = out
    assert torch.equal(l0, l1) and torch.equal(p0, p1)
    for (h0, w0), (h1, w1) in zip(t0, t1):
        assert torch.equal(h0, h1) and torch.equal(w0, w1)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity,max_probes,n", [
    (32, 2, 48),      # two buckets, two lanes a key: most ids overflow
    (32, 32, 48),     # every lane tried: 32 placed, 16 overflow
    (1024, 32, 200),  # room for all: no id left out
])
def test_insert_counters_witness_unplaced_ids(capacity, max_probes, n):
    """A training lookup over a table too small for its ids: ``unplaced``
    is the ids left with slot -1, ``misses == inserted + unplaced`` and
    ``unique_ids`` is dedup's ``num_unique``; the ids' duplicates and pads
    count in ``ids``."""
    t = kv.create(4, capacity, max_probes=max_probes, seed=0, device="cpu")
    rng = np.random.RandomState(capacity + max_probes)
    uniq = rng.permutation(np.arange(1, 4 * n + 1, dtype=np.int64))[:n] \
        * 7919
    ids = np.concatenate([uniq, uniq[:16]])
    valid = torch.ones(ids.shape[0], dtype=torch.bool)
    valid[-4:] = False
    profiling.reset_counters()
    look, t = embedding.lookup_unique(t, ids, valid=valid)
    c = profiling.counters()
    slot = look.slot[:int(look.num_unique)]
    assert c["unplaced"] == int((slot < 0).sum())
    assert c["inserted"] == int((slot >= 0).sum())
    assert c["misses"] == c["inserted"] + c["unplaced"] == n
    assert c["unique_ids"] == int(look.num_unique) == n
    assert c["ids"] == n + 16 and c["lookups"] == 1
    assert c["claim_rounds"] <= max_probes
    assert (c["unplaced"] > 0) == (capacity < n)
    # the same ids again: all found or still unplaced, no claim round
    # places a found id
    profiling.reset_counters()
    embedding.lookup_unique(t, ids, valid=valid)
    again = profiling.counters()
    assert again["misses"] == again["unplaced"] == c["unplaced"]


def test_counters_add_up_across_threads():
    """Eight threads adding at once lose no count; a reset zeros all."""
    profiling.reset_counters()

    def work():
        for _ in range(2000):
            profiling.count(ids=1, unique_ids=2)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    c = profiling.counters()
    assert (c["ids"], c["unique_ids"]) == (16000, 32000)
    assert set(c) == set(profiling.COUNTERS)
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}


def test_device_counts_fold_into_counters():
    """Counts kernels add into a device's buffer (here the CPU's, added
    as tensors) appear in ``counters()`` beside the host's counts, keep
    ``misses == inserted + unplaced`` and ``found <= probed``, and
    ``reset_counters()`` zeros both."""
    profiling.reset_counters()
    profiling.count(misses=5, claim_rounds=2, inserted=4, unplaced=1,
                    probed=2, found=1)
    buf = profiling.device_counts("cpu")
    assert buf is profiling.device_counts(torch.device("cpu"))
    assert buf.dtype == torch.int64
    assert buf.shape == (len(profiling.DEVICE_COUNTERS),)
    # the claim insert's four, then the probe's two
    assert profiling.DEVICE_COUNTERS[4:] == ("probed", "found")
    buf.add_(torch.tensor([7, 3, 6, 1, 9, 4]))
    buf[profiling.DEVICE_COUNTERS.index("claim_rounds")] += torch.tensor(2)
    c = profiling.counters()
    assert (c["misses"], c["claim_rounds"], c["inserted"],
            c["unplaced"]) == (12, 7, 10, 2)
    assert c["misses"] == c["inserted"] + c["unplaced"]
    assert (c["probed"], c["found"]) == (11, 5)
    assert set(c) == set(profiling.COUNTERS)
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}
    assert not bool(buf.any())


def test_claim_kernel_takes_card_tensors_only():
    """The claim-insert kernel's wrapper refuses CPU tensors (the table
    runs its Python rounds there) and launches nothing."""
    header = kv.table._empty_header(4, "cpu")
    q = torch.zeros((3, 2), dtype=torch.int32)
    need = torch.ones((3,), dtype=torch.bool)
    launches = claim.claim_insert.launches
    with pytest.raises(ValueError, match="CUDA"):
        claim.claim_insert(header, q, need, 32)
    assert claim.claim_insert.launches == launches


def test_probe_kernel_takes_card_tensors_only():
    """The probe kernel's wrapper refuses CPU tensors (the table runs its
    plain find there) and launches nothing."""
    header = kv.table._empty_header(4, "cpu")
    q = torch.zeros((3, 2), dtype=torch.int32)
    launches = probe.probe.launches
    for valid in (None, torch.ones((3,), dtype=torch.bool)):
        with pytest.raises(ValueError, match="CUDA"):
            probe.probe(header, q, valid)
    assert probe.probe.launches == launches


def test_find_counts_probed_and_found():
    """``find`` on the CPU counts the valid keys it probed and the keys it
    found: of keys half of which the table holds, exactly half, and
    reserved ids and keys ``valid`` leaves out in neither."""
    rng = np.random.RandomState(11)
    t = kv.create(4, 1 << 10, device="cpu")
    ids = np.unique(rng.randint(1, 1 << 40, 400).astype(np.int64))[:300]
    held = hashing.encode_ids(ids[::2], device="cpu")
    kv.insert(t, held, torch.zeros((held.shape[0], 4)))
    q = hashing.encode_ids(ids, device="cpu")
    profiling.reset_counters()
    fr = kv.find(t, q)
    c = profiling.counters()
    assert (c["probed"], c["found"]) == (300, 150)
    assert int(fr.found.sum()) == 150
    # reserved ids (EMPTY, TOMBSTONE) and keys left out are not probed
    q2 = torch.cat([q, torch.tensor([[hashing.EMPTY_LO, hashing.EMPTY_HI],
                                     [hashing.TOMB_LO, hashing.TOMB_HI]],
                                    dtype=torch.int32)])
    valid = torch.ones((q2.shape[0],), dtype=torch.bool)
    valid[:100] = False
    profiling.reset_counters()
    fr = kv.find(t, q2, valid)
    c = profiling.counters()
    assert c["probed"] == 200 and c["found"] == 100
    assert c["found"] <= c["probed"]
    assert not bool(fr.found[:100].any() or fr.found[-2:].any())
    profiling.reset_counters()
