"""Profiling and step metering: the observability layer.

Counterpart of ``tfplus_tpu/utils/profiling.py``. Where the JAX package
wraps ``jax.profiler`` traces for XProf, :func:`trace` records a
``torch.profiler`` trace that TensorBoard's profiler plugin reads;
:class:`StepMeter` tracks examples/s and step-time percentiles on the
host's clock.

The sparse step marks its layers with :class:`annotate` spans, which open a
``record_function`` range only while a profiler records (a ``trace`` block,
or any other ``torch.profiler.profile`` block), so they cost one flag read
otherwise. Their names are fixed:

=====================  ====================================================
``tfp::step``          one training step or serving request
``tfp::feed``          host inputs (ids, features, labels) to the device
``tfp::lookup``        one table's lookup (``embedding.lookup_unique``)
``tfp::dedup``         ``kv.unique_with_counts``
``tfp::probe``         ``kv.find``: both bucket scans (on the card one
                       probe kernel launch)
``tfp::insert``        placing a lookup's misses: claim rounds, initial
                       rows, meta write (on the CPU only when the batch
                       has misses; on the card always: one claim launch,
                       one row scatter)
``tfp::claim_round``   one round of the claim insert (CPU tensors only: on
                       the card every round runs inside the kernel)
``tfp::gather``        the payload row gather of a lookup
``tfp::forward``       the take to the batch, the dense towers and the loss
``tfp::backward``      ``torch.autograd.grad`` over the towers and rows
``tfp::dense_opt``     the dense optimizer's step
``tfp::sparse_opt``    ``SparseOptimizer.apply`` on one table
=====================  ====================================================

:func:`counters` counts, always and at the cost of a host integer add, what
the host already holds, and what kernels add on the device into the buffer
of :func:`device_counts` (the claim insert's and the probe's counts on the
card), which it reads once a device only when asked;
:func:`reset_counters` zeros both.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block into ``log_dir`` (a
    ``*.pt.trace.json`` that TensorBoard's profiler reads). CPU activity
    always, CUDA activity too when ``torch.cuda.is_available()``: this picks
    what is recorded, not where anything runs. Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class annotate:
    """A named range in the trace (``torch.profiler.record_function``),
    opened only while a profiler records; otherwise nothing."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        r, self._range = self._range, None
        if r is not None:
            r.__exit__(*exc)
        return False


#: the counters of :func:`counters`
COUNTERS = (
    "lookups",       # embedding.lookup_unique calls
    "ids",           # ids handed to dedup (the input's length, pads too)
    "unique_ids",    # valid unique ids dedup found
    "misses",        # ids a claim insert had to place: a training
                     # lookup's misses, and a table load's or rehash's
                     # new keys (a serving lookup places none: its misses
                     # are probed - found)
    "claim_rounds",  # claim rounds run
    "inserted",      # misses placed
    "unplaced",      # misses left with no slot (both buckets full): a
                     # training lookup then reads zeros for them and does
                     # not update them
    "probed",        # valid keys a probe (kv.find) looked for, in every
                     # caller: lookups (serving's too), loads, deletes
    "found",         # of those, the keys the table held: found / probed
                     # is the probes' hit share
)
#: the counters kernels add on the device, in the order of the buffer of
#: :func:`device_counts`: the claim insert's four, then the probe's two
DEVICE_COUNTERS = ("misses", "claim_rounds", "inserted", "unplaced",
                   "probed", "found")
_counts = dict.fromkeys(COUNTERS, 0)
_device_counts: Dict[torch.device, torch.Tensor] = {}
_counts_lock = threading.Lock()


def count(**added: int) -> None:
    """Add to counters by name, e.g. ``count(lookups=1, ids=n)``."""
    with _counts_lock:
        for name, n in added.items():
            _counts[name] += n


def device_counts(device) -> torch.Tensor:
    """The process-wide int64[len(DEVICE_COUNTERS)] buffer on ``device``
    into which kernels add their counts, with no host read; made zero at
    first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _counts_lock:
        buf = _device_counts.get(dev)
        if buf is None:
            buf = _device_counts[dev] = torch.zeros(
                (len(DEVICE_COUNTERS),), dtype=torch.int64, device=dev)
    return buf


def counters() -> Dict[str, int]:
    """A snapshot of the process-wide counters, the device buffers folded
    in (one read a device that has one). ``misses == inserted + unplaced``
    and ``found <= probed`` always hold."""
    with _counts_lock:
        out = dict(_counts)
        for buf in _device_counts.values():
            for name, n in zip(DEVICE_COUNTERS, buf.tolist()):
                out[name] += n
    return out


def reset_counters() -> None:
    """Zero every counter, on the host and in the device buffers."""
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0
        for buf in _device_counts.values():
            buf.zero_()


class StepMeter:
    """Rolling training-step metrics (examples/s, ms/step percentiles)."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: List[float] = []
        self._examples: List[int] = []
        self._last: Optional[float] = None
        self.total_steps = 0
        self.total_examples = 0

    def step(self, batch_size: int):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._examples.append(batch_size)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._examples.pop(0)
        self._last = now
        self.total_steps += 1
        self.total_examples += batch_size

    def snapshot(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": self.total_steps}
        t = np.array(self._times)
        return {
            "steps": self.total_steps,
            "examples_per_s": float(sum(self._examples) / t.sum()),
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p99": float(np.percentile(t, 99) * 1e3),
        }
