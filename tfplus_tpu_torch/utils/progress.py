"""Console progress reporting for long-running host-side work.

A copy of ``tfplus_tpu/utils/progress.py``, the reference's ProgressBar
(utils/progress_bar.{h,cc}). Checkpoint restore draws it when a table has at
least ``MIN_ROWS_FOR_BAR`` rows; silent otherwise and on non-TTY outputs.
"""
from __future__ import annotations

import os
import sys
import time

MIN_ROWS_FOR_BAR = 1_000_000


class ProgressBar:
    """Minimal single-line progress bar.

    >>> bar = ProgressBar("restore emb/part_0", total=10)
    >>> for _ in range(10):
    ...     bar.update(1)
    >>> bar.done()
    """

    def __init__(self, label: str, total: int, *, width: int = 30,
                 stream=None, enabled: bool | None = None,
                 min_interval_s: float = 0.1):
        self.label = label
        self.total = max(int(total), 1)
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        if enabled is None:
            enabled = (hasattr(self.stream, "isatty") and self.stream.isatty()
                       and not os.environ.get("TFPLUS_TPU_NO_PROGRESS"))
        self.enabled = bool(enabled)
        self.count = 0
        self.start = time.monotonic()
        self._min_interval = min_interval_s
        self._last_draw = 0.0
        self._drawn = False

    def update(self, n: int = 1) -> None:
        self.count += n
        now = time.monotonic()
        if not self.enabled or (now - self._last_draw < self._min_interval
                                and self.count < self.total):
            return
        self._last_draw = now
        frac = min(self.count / self.total, 1.0)
        filled = int(frac * self.width)
        elapsed = now - self.start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.count) / rate if rate > 0 else 0.0
        self.stream.write(
            f"\r{self.label}: [{'#' * filled}{'.' * (self.width - filled)}] "
            f"{frac * 100:5.1f}%  {elapsed:5.1f}s  eta {eta:5.1f}s")
        self.stream.flush()
        self._drawn = True

    def done(self) -> None:
        if self.enabled and self._drawn:
            elapsed = time.monotonic() - self.start
            self.stream.write(
                f"\r{self.label}: [{'#' * self.width}] 100.0%  "
                f"{elapsed:5.1f}s\n")
            self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.done()
