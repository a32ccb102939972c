"""Profiling and step metering: the observability layer.

Counterpart of ``tfplus_tpu/utils/profiling.py``. Where the JAX package
wraps ``jax.profiler`` traces for XProf, :func:`trace` records a
``torch.profiler`` trace that TensorBoard's profiler plugin reads, and
:func:`annotate` is a ``record_function`` range; :class:`StepMeter` tracks
examples/s and step-time percentiles on the host's clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block into ``log_dir`` (a
    ``*.pt.trace.json`` that TensorBoard's profiler reads). CPU activity
    always, CUDA activity too when ``torch.cuda.is_available()``: this picks
    what is recorded, not where anything runs. Yields the profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    import torch
    with torch.profiler.record_function(name):
        yield


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
