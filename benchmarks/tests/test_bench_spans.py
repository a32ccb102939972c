"""The readers of the program's spans (``benchlib/spans.py`` and the
metrics that use it) on a hand-made trace: each layer's idle time, syncs
and claim rounds, and the sums that tie them to the trace's own totals."""
import pytest

from benchlib import compare, peaks, spans, trace
from benchlib.files import Files

from test_bench_arith import ev, hand_trace


def span(name, ts, end, tid=1):
    return ev("user_annotation", name, ts, end - ts, tid=tid)


def sync(ts, tid=1):
    return ev("cuda_runtime", "cudaStreamSynchronize", ts, 2, tid=tid)


def step_trace():
    """A 200 us window: kernels at 10-20, 50-60, 120-130 and 170-180; one
    training step (5-160) on thread 1 with every layer's spans; autograd's
    thread 2 syncs inside the backward; the harness's copy at 160-190."""
    return trace.Trace([
        span("bench::window", 0, 200),
        *[ev("kernel", "k", a, 10) for a in (10, 50, 120, 170)],
        span("tfp::step", 5, 160),
        span("tfp::lookup", 5, 70),
        span("tfp::feed", 5, 15),
        span("tfp::dedup", 15, 30),
        span("tfp::probe", 30, 40),
        span("tfp::insert", 40, 60),
        span("tfp::claim_round", 42, 48),
        span("tfp::claim_round", 50, 56),
        span("tfp::gather", 60, 70),
        span("tfp::forward", 75, 100),
        span("tfp::feed", 75, 80),
        span("tfp::backward", 100, 120),
        span("tfp::dense_opt", 120, 125),
        span("tfp::sparse_opt", 130, 150),
        span("bench::copy", 160, 190),
        ev("cpu_op", "aten::nonzero", 24, 4),
        *[sync(t) for t in (25, 45, 52, 65, 78, 140, 152, 170, 195)],
        ev("cpu_op", "autograd::engine", 105, 10, tid=2),
        sync(110, tid=2),
    ])


IDLE_US = {"feed": 10, "lookup": 30, "insert": 10, "dense": 40,
           "sparse_opt": 20, None: 50}
SYNCS = {"lookup": 2, "insert": 2, "feed": 1, "dense": 1, "sparse_opt": 1,
         None: 2}


def view(kind, tr):
    return compare.View(kind=kind, trace=tr, steps=2, flops=0.0,
                        rows_bytes=0.0, attention_bound_s=None,
                        peak_flops=peaks.FLOPS["float32"])


def test_split_cuts_every_gap_and_sync_by_layer():
    tr = step_trace()
    s = spans.split(tr)
    assert s["idle_us"] == pytest.approx(IDLE_US)
    assert s["syncs"] == SYNCS
    assert s["claim_rounds"] == 2
    # the layers and the time outside them add up to the trace's totals
    assert sum(s["syncs"].values()) == tr.syncs == 9
    idle = (tr.hi - tr.lo) - 1e6 * tr.busy_s
    assert sum(s["idle_us"].values()) == pytest.approx(idle)
    assert sum(b - a for a, b in tr.gaps()) == pytest.approx(idle)


@pytest.mark.parametrize("name,want", [
    ("feed_idle_ms.train", 10 / 2e3),
    ("lookup_idle_ms.train", 30 / 2e3),
    ("insert_idle_ms.train", 10 / 2e3),
    ("sparse_opt_idle_ms.train", 20 / 2e3),
    ("dense_idle_ms.train", 40 / 2e3),
    ("lookup_syncs_per_step.train", 1.0),
    ("insert_syncs_per_step.train", 1.0),
    ("claim_rounds_per_step.train", 1.0),
    ("feed_idle_ms.serve", 10 / 2e3),
    ("lookup_idle_ms.serve", 30 / 2e3),
    ("dense_idle_ms.serve", 40 / 2e3),
    ("lookup_syncs_per_request.serve", 1.0),
])
def test_each_reader_on_the_step_trace(bench, name, want):
    """Each new reader gives its layer's number per step (two steps), and
    None on the other kind of cell and on a program without spans."""
    read = Files(bench).module("metrics", name).read
    kind = name.rsplit(".", 1)[1]
    other = "serve" if kind == "train" else "train"
    assert read(view(kind, step_trace())) == pytest.approx(want)
    assert read(view(other, step_trace())) is None
    assert read(view(kind, hand_trace())) is None   # no tfp::step
    assert spans.split(hand_trace()) is None
