"""The metric arithmetic on hand-made cases: the window rate, the 95th
percentile over all requests, the trace's busy union, syncs and gaps, and
the per-layer readers' operations and bytes."""
import time

import numpy as np
import pytest

from benchlib import compare, layers, peaks, runner, trace
from benchlib.program import SparseProgram


def ev(cat, name, ts, dur, tid=1, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def hand_trace():
    """A 100 us window: kernels at 10-30 and 20-40 (overlapping), a memcpy
    at 60-70, a kernel that starts before the window (left out); host ops
    around them; two syncs, one inside the harness's copy range."""
    return trace.Trace([
        ev("user_annotation", "bench::warm", -50, 40),
        ev("kernel", "void warm_kernel<1>(int)", -40, 5),
        ev("user_annotation", "bench::window", 0, 100),
        ev("kernel", "void rows_kernel<4, 2>(int*)", 10, 20),
        ev("kernel", "void at::native::gather_rows_kernel<1>()", 20, 20),
        ev("gpu_memcpy", "Memcpy DtoH", 60, 10),
        ev("cpu_op", "aten::step", 0, 95),
        ev("cpu_op", "aten::nonzero", 40, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", 45, 10),
        ev("user_annotation", "bench::copy", 70, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", 75, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 2),
    ])


def test_trace_union_window_syncs():
    tr = hand_trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)        # 10-40 and 60-70
    assert tr.launches == 2
    assert tr.syncs == 1                 # the one in bench::copy is left out
    assert tr.kernel_s(layers.ROWS_KERNEL) == pytest.approx(20e-6)
    assert tr.gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]


def test_breakdown_names_the_host_op_in_each_gap():
    out = hand_trace().breakdown()
    ops = dict(out["device_ops"])
    assert ops["rows_kernel"] == pytest.approx(20e-6)
    assert ops["at::native::gather_rows_kernel"] == pytest.approx(20e-6)
    idle = dict(out["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == pytest.approx(20e-6)  # mid 50
    assert idle["bench::copy"] == pytest.approx(30e-6)       # mid 85
    assert idle["aten::step"] == pytest.approx(10e-6)        # mid 5


def test_merge_and_union():
    assert trace.merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert trace.union_length([(0, 2), (1, 3), (5, 6)], 1, 5.5) == 2.5


def test_p95_over_all_requests():
    assert runner.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert runner.p95([7.0]) == 7.0
    xs = list(np.random.default_rng(0).random(1000))
    assert runner.p95(xs) == pytest.approx(np.percentile(xs, 95))


class _Prog:
    """A program whose step takes 20 ms and reads one batch of 8."""
    device = __import__("torch").device("cpu")

    class traffic:
        @staticmethod
        def batch(s):
            return {"ids": {}, "features": None, "labels": None}

        @staticmethod
        def feed(b):
            return b

    state = None

    def __init__(self, train):
        self.train = train

    @staticmethod
    def step(state, batch):
        time.sleep(0.02)
        torch = __import__("torch")
        return state, torch.zeros(()), torch.zeros(8)


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
def test_window_rate_counts_every_step_over_the_whole_window(train):
    loop = runner.Loop(_Prog(train), 0)
    window = loop.run_for(0.2)
    n = len(loop.done)
    assert window >= 0.2 and n * 0.02 <= window + 1e-3
    # the window closes after the last step: the rate is steps over it
    assert n * 8 / window == pytest.approx(8 / 0.02, rel=0.15)
    # serving: one caller, every request of the window timed from its call
    assert len(loop.latency_s) == (0 if train else n)
    assert all(0.02 <= t < 0.2 for t in loop.latency_s)
    assert sum(loop.pieces(0.05)) * 0.05 <= n


def view(kind, flops=0.0, rows_bytes=0.0, attention=None):
    return compare.View(kind=kind, trace=hand_trace(), steps=2, flops=flops,
                        rows_bytes=rows_bytes, attention_bound_s=attention,
                        peak_flops=peaks.FLOPS["float32"])


def test_readers_on_the_hand_trace():
    v = view("train", flops=67e12 * 1e-6, rows_bytes=3.35e12 * 5e-6,
             attention=2e-6)
    assert layers.mfu(v, "train") == pytest.approx(1.0)     # 1 us of 100
    assert layers.mfu(v, "serve") is None
    assert layers.device_idle(v, "train") == pytest.approx(60.0)
    assert layers.launches(v, "train") == 1.0
    assert layers.host_syncs(v, "train") == 0.5
    assert layers.rows_roofline(v, "train") == pytest.approx(25.0)
    assert layers.flash_roofline(v, "train") is None        # no flash kernel
    assert layers.flash_roofline(view("train"), "train") is None


def test_readers_return_nothing_without_device_events():
    v = compare.View(kind="serve", trace=trace.Trace(
        [ev("user_annotation", "bench::window", 0, 10)]), steps=1,
        flops=1.0, rows_bytes=1.0, attention_bound_s=1.0, peak_flops=1.0)
    for f in (layers.mfu, layers.device_idle, layers.launches,
              layers.host_syncs, layers.rows_roofline, layers.flash_roofline):
        assert f(v, "serve") is None


def _program_for(cfg, train):
    """The counting methods alone, without building tables."""
    prog = SparseProgram.__new__(SparseProgram)
    prog.cfg, prog.train = cfg, train
    return prog


def test_row_bytes_and_model_operations(tiny):
    files, _ = tiny
    cfg = files.config("dcn_criteo")
    adapter = files.model("dcn_criteo")
    prog = _program_for(cfg, True)
    prog.adapter, prog.tables = adapter, adapter.tables(cfg)
    fresh = 1 << 41
    res = (1 << 40) + 5
    batch = {"ids": {"C1": np.array([res, res, fresh]),
                     "C2": np.array([res, res + 1, res + 2]),
                     "C3": np.array([res, res, res])},
             "labels": np.zeros(3)}
    # train: (2 * unique + fresh) rows of dim * (1 + 3 GroupAdam slots)
    want = ((2 * 2 + 1) * (2 * 8 * 4 * 4 + 4) + (2 * 3) * (2 * 16 * 4 * 4 + 4)
            + 2 * (2 * 8 * 4 * 4 + 4))
    assert prog.rows_bytes(batch) == want
    prog.train = False
    want = 1 * (2 * 8 * 4 + 4) + 3 * (2 * 16 * 4 + 4) + 1 * (2 * 8 * 4 + 4)
    assert prog.rows_bytes(batch) == want
    # DCN: 2·(in·h) per layer plus the cross network, per example
    d_in = 8 + 16 + 8 + 13
    per = 2 * (d_in * 32 + 32 * 16 + 16 * 1) + 2 * d_in * 3
    assert prog.model_flops(batch) == 3 * per
    prog.train = True
    assert prog.model_flops(batch) == 3 * 3 * per


def test_attention_work_from_the_masks(tiny):
    files, _ = tiny
    cfg = files.config("bst_taobao")
    adapter = files.model("bst_taobao")
    mask = np.zeros((2, 6), np.float32)
    mask[0, :3] = 1                       # 3 history items + candidate: 4
    batch = {"features": {"mask": mask}, "labels": np.zeros(2)}
    work = adapter.attention_work(batch, cfg)
    assert work == {"rows": 2 * (4 + 1), "pairs": 2 * (16 + 1),
                    "head_dim": 8}
    prog = _program_for(cfg, False)
    prog.adapter = adapter
    t = prog.attention_bound_s(batch)
    assert t == pytest.approx(max(4 * 8 * 34 / 67e12,
                                  4 * 10 * 8 * 4 / 3.35e12))
