"""The reductions that the per-layer readers (``metrics/<name>.py``) share.
Each returns None where the traced stretch holds nothing to read: another
kind of cell, no device events (a run without a card), or no kernel of the
layer. A share of a peak or a roofline is never given as 0 for want of
data."""
from __future__ import annotations

from . import peaks

ROWS_KERNEL = r"\brows_kernel\b"       # ops/csrc/rowops.cu
FLASH_KERNELS = r"\bflash_\w*kernel"   # ops/csrc/flash_*.cu


def _on_device(view, kind):
    return view.kind == kind and view.trace.launches > 0


def mfu(view, kind):
    """Model operations of the traced steps over the stretch's length and
    the float32 peak, in percent."""
    if not _on_device(view, kind):
        return None
    return 100 * view.flops / view.trace.window_s / view.peak_flops


def device_idle(view, kind):
    """The share of the stretch in which no kernel, memcpy or memset ran."""
    if not _on_device(view, kind):
        return None
    return 100 * (1 - view.trace.busy_s / view.trace.window_s)


def launches(view, kind):
    if not _on_device(view, kind):
        return None
    return view.trace.launches / view.steps


def host_syncs(view, kind):
    """CUDA runtime synchronize calls of the program per step, the
    harness's own copies and closing synchronize left out."""
    if not _on_device(view, kind):
        return None
    return view.trace.syncs / view.steps


def rows_roofline(view, kind):
    """Bytes the row kernels needed over the HBM rate, over their summed
    device time, in percent."""
    if not _on_device(view, kind):
        return None
    t = view.trace.kernel_s(ROWS_KERNEL)
    if t <= 0:
        return None
    return 100 * view.rows_bytes / peaks.HBM_BYTES_PER_S / t


def flash_roofline(view, kind):
    """The attention kernels' least time on these masks over their summed
    device time, in percent."""
    if not _on_device(view, kind) or view.attention_bound_s is None:
        return None
    t = view.trace.kernel_s(FLASH_KERNELS)
    if t <= 0:
        return None
    return 100 * view.attention_bound_s / t
