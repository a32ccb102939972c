"""One ``torch.profiler`` trace (CPU and CUDA) over a bounded stretch of the
window, and its reduction to the numbers the per-layer metrics read.

The traced stretch is the ``bench::window`` range that the loop records on
the host; it closes on a device synchronize. Device work is every kernel,
memcpy and memset event that starts inside it; the harness's own copies of
results to the host and its closing synchronize run inside ``bench::copy``
and ``bench::sync`` ranges and are left out of the sync count.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW = "bench::window"
HARNESS = ("bench::copy", "bench::sync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def export_events(prof) -> list:
    """The stopped profiler's trace events (written to a temporary file
    under ``TMPDIR``, read back and deleted)."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments or parameters."""
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def merge(intervals):
    """Sorted, non-overlapping union of ``(start, end)`` pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def union_length(intervals, lo=None, hi=None) -> float:
    total = 0.0
    for a, b in merge(intervals):
        a = a if lo is None else max(a, lo)
        b = b if hi is None else min(b, hi)
        total += max(0.0, b - a)
    return total


def innermost(events, points):
    """For each of the sorted ``points``, the name of the latest-starting
    event of ``events`` (``(start, end, name)``, properly nested) that
    covers it, or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


class Trace:
    """The traced stretch of one run: times in microseconds."""

    def __init__(self, events: list):
        wins = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW]
        if len(wins) != 1:
            raise ValueError(f"expected one {WINDOW} range, found {len(wins)}")
        self.lo = float(wins[0]["ts"])
        self.hi = self.lo + float(wins[0]["dur"])
        inside = [e for e in events if e.get("ph") == "X"
                  and self.lo <= float(e["ts"]) < self.hi]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"], e["cat"]) for e in inside
                       if e.get("cat") in DEVICE_CATS]
        harness = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in inside if e.get("cat") == "user_annotation"
                   and e.get("name") in HARNESS]
        self.syncs = sum(
            1 for e in inside if e.get("cat") == "cuda_runtime"
            and e.get("name") in SYNC_CALLS
            and not any(a <= float(e["ts"]) < b for a, b in harness))
        self.host = defaultdict(list)
        for e in inside:
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
                ts = float(e["ts"])
                self.host[e.get("tid")].append(
                    (ts, ts + float(e["dur"]), e["name"]))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _, _ in self.device],
                            self.lo, self.hi) / 1e6

    @property
    def launches(self) -> int:
        return sum(1 for e in self.device if e[3] == "kernel")

    def kernel_s(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, name, cat in self.device
                   if cat == "kernel" and rx.search(name)) / 1e6

    def gaps(self):
        """Idle stretches of the device inside the window."""
        out, at = [], self.lo
        for a, b in merge([(a, b) for a, b, _, _ in self.device]):
            if a > at:
                out.append((at, min(a, self.hi)))
            at = max(at, b)
        if at < self.hi:
            out.append((at, self.hi))
        return [(a, b) for a, b in out if b > a]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host operation running at each gap's middle (the
        latest-starting one over the host threads)."""
        ops = defaultdict(float)
        for a, b, name, _ in self.device:
            ops[short_name(name)] += (b - a) / 1e6
        gaps = self.gaps()
        mids = [(a + b) / 2 for a, b in gaps]
        per_thread = [innermost(evs, mids) for evs in self.host.values()]
        idle = defaultdict(float)
        for j, (a, b) in enumerate(gaps):
            found = [p[j] for p in per_thread if p[j] is not None]
            name = max(found)[2] if found else "(host idle)"
            idle[name] += (b - a) / 1e6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gap_order = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gap_order]}
