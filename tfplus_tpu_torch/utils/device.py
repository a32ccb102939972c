"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. A CUDA request on a machine
without a usable card raises instead of running on the CPU: the CPU is taken
only when the caller names it (the tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {d} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return d
