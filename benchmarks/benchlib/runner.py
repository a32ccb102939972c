"""One run of one cell: set-up, the measured window (or the traced
stretch), the check against the reference, and the result.

Both kinds of cell are a closed loop with one caller: training steps, or
serving requests each timed from the call until its predictions are on the
host, back to back. The window closes on a device synchronize after the
step or request that crosses its end.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import compare, inputs, peaks
from .program import SparseProgram
from .trace import Trace, export_events


def _log(t_start: float, msg: str) -> None:
    print(f"[bench] {time.perf_counter() - t_start:9.3f} s  {msg}",
          file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _range(name: str):
    return torch.profiler.record_function(name)


def p95(values) -> float:
    """The 95th percentile, interpolated between closest ranks."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = 0.95 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Loop:
    """The window's loop over the program's step, a closed loop with one
    caller: training steps, or serving requests each timed from the call
    until its predictions are on the host, back to back."""

    def __init__(self, prog: SparseProgram, first: int):
        self.prog, self.next = prog, first
        self.done = []            # step or request indices, in order
        self.ends = []            # when each returned, on the host's clock
        self.latency_s = []       # serving: per request
        self.preds = {}           # serving: request index -> host preds
        self.losses = []          # training: device losses

    def one(self):
        prog, s = self.prog, self.next
        batch = prog.traffic.feed(prog.traffic.batch(s))
        start = time.perf_counter()
        if prog.train:
            prog.state, loss, _ = prog.step(prog.state, batch)
            self.losses.append(loss)
        else:
            _, _, preds = prog.step(prog.state, batch)
            with _range("bench::copy"):
                self.preds[s] = preds.cpu().numpy()
        end = time.perf_counter()
        if not prog.train:
            self.latency_s.append(end - start)
        self.ends.append(end)
        self.done.append(s)
        self.next += 1

    def clear(self):
        for xs in (self.done, self.ends, self.latency_s, self.losses):
            xs.clear()

    def run_for(self, seconds: float, min_steps: int = 1) -> float:
        """Steps or requests back to back until ``seconds`` have passed
        (and at least ``min_steps``), then a synchronize; returns the
        window's length, from its start (kept in ``t0``) to the end of the
        synchronize."""
        dev = self.prog.device
        _sync(dev)
        self.t0 = t0 = time.perf_counter()
        n = 0
        while True:
            self.one()
            n += 1
            if n >= min_steps and time.perf_counter() - t0 >= seconds:
                break
        with _range("bench::sync"):
            _sync(dev)
        return time.perf_counter() - t0

    def pieces(self, seconds: float) -> list:
        """Steps or requests returned in each whole ``seconds`` of the
        window, a second: whether the rate drifts or stalls inside a run."""
        n = int((self.ends[-1] - self.t0) // seconds) if self.ends else 0
        counts = [0] * n
        for t in self.ends:
            k = int((t - self.t0) // seconds)
            if k < n:
                counts[k] += 1
        return [c / seconds for c in counts]


def traced(loop: Loop, seconds: float, min_steps: int):
    """Profile one warm-up step, then ``bench::window`` over a stretch of
    ``seconds`` (at least ``min_steps``): returns the stretch's indices and
    its :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if loop.prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with _range("bench::warm"):
            loop.one()
            _sync(loop.prog.device)
        first = len(loop.done)
        with _range("bench::window"):
            loop.run_for(seconds, min_steps)
    return loop.done[first:], Trace(export_events(prof))


def per_layer(prog: SparseProgram, trace: Trace, indices, readers) -> dict:
    """The per-layer metrics: each reader gets a view of the traced
    stretch and returns a number, or None where it finds nothing to read."""
    batches = [prog.traffic.batch(i) for i in indices]
    bounds = [prog.attention_bound_s(b) for b in batches]
    view = compare.View(
        kind="train" if prog.train else "serve", trace=trace,
        steps=len(batches),
        flops=sum(prog.model_flops(b) for b in batches),
        rows_bytes=sum(prog.rows_bytes(b) for b in batches),
        attention_bound_s=(None if bounds and bounds[0] is None
                           else sum(bounds)),
        peak_flops=peaks.FLOPS["float32"])
    out = {}
    for name, (unit, reader) in readers.items():
        value = reader.read(view)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def run(files, cell: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, hooks=None) -> dict:
    """One run of ``cell`` (an entry of ``workloads``); returns the result
    without the device block. ``hooks(prog)`` may replace parts of the
    program before set-up ends (tests plant faults so)."""
    device = torch.device(device)
    cfg = files.config(cell["config"])
    mix = files.traffic(cell["traffic"])
    adapter = files.model(cell["config"])
    limits = files.limits(cell["name"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _log(t_start, f"{cell['name']} seed {seed}: building")
    prog = SparseProgram(adapter, cfg, mix, seed, device)
    _log(t_start, "tables filled, traffic made; ids the fill left out: "
         f"{sum(prog.unplaced.values())}")
    if hooks is not None:
        hooks(prog)
    readings = None
    if prog.train:
        readings = prog.check_steps(mix["check_steps"])
        first = mix["check_steps"]
    else:
        first = 0
    loop = Loop(prog, first)
    for _ in range(mix["warmup_steps"]):
        loop.one()
    _sync(device)
    loop.clear()
    setup_s = time.perf_counter() - t_start
    _log(t_start, "set-up done")

    metrics, result = {}, {}
    if trace:
        indices, tr = traced(loop, min(seconds, mix["trace_seconds"]),
                             mix["trace_min_steps"])
        metrics = per_layer(prog, tr, indices, files.readers(cell))
        result["busy_s"], result["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        window_s = loop.run_for(seconds)
        rate = len(loop.done) * mix["batch"] / window_s
        if prog.train:
            metrics["train_examples_per_s"] = {"value": rate,
                                               "unit": "examples/s"}
        else:
            metrics["serve_examples_per_s"] = {"value": rate,
                                               "unit": "examples/s"}
            metrics["serve_p95_ms"] = {"value": 1e3 * p95(loop.latency_s),
                                       "unit": "ms"}
        _log(t_start, "steps or requests a second in each 5 s of the "
             f"window: {[round(r, 3) for r in loop.pieces(5.0)]}")
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        reported = {m["name"] for m in files.end_to_end(cell)}
        metrics = {k: v for k, v in metrics.items() if k in reported}
    attempted = len(loop.done)
    _log(t_start, f"window done: {attempted} steps or requests")
    if prog.train:
        losses = torch.stack(loop.losses).cpu().numpy() if loop.losses \
            else np.zeros(0)
        failed = int((~np.isfinite(losses)).sum())
    else:
        failed = sum(1 for s in loop.done
                     if not np.isfinite(loop.preds[s]).all())
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)

    # the check: the program's state goes, then the reference runs
    served = {s: loop.preds[s] for s in _sample(loop.done, seed,
                                                mix.get("check_requests", 0))}
    del loop
    prog.release()
    gc.collect()
    checks = (compare.training(prog, readings, limits) if prog.train
              else compare.serving(prog, served, limits))
    _log(t_start, "reference done")
    result.update(attempted=attempted, failed=failed, metrics=metrics,
                  checks=checks,
                  correct=failed == 0 and compare.passed(checks))
    return result


def _sample(done, seed: int, k: int):
    """``k`` request indices drawn from the seed among those served."""
    if not done or not k:
        return []
    rng = np.random.default_rng(inputs.derive(seed, "sample"))
    pick = rng.choice(len(done), size=min(k, len(done)), replace=False)
    return sorted(done[i] for i in pick)
