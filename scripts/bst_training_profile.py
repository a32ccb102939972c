#!/usr/bin/env python3
"""Profile BST training at published widths from one checkout, on one CUDA
card.

    python3 scripts/bst_training_profile.py CHECKOUT OUT_DIR

Runs ``chip_smoke.py``'s BST training phase (the item and user tables with
Adam's slots, batch-2048 steps, the launch counts it expects per step)
from the checkout at CHECKOUT with ``torch.profiler`` on, and writes the
table of ops and kernels to OUT_DIR. It prints the phase's examples/s and
the profiled device ms per step. Runs from two checkouts in turns in one
call (A, B, B, A) compare two versions on one card.
"""
import os
import sys


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, out_dir = os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bst_training_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from tfplus_tpu_torch import kv, models, train
    print(f"BST training from {sys.argv[1]}", flush=True)
    chip_smoke.bst_training_phase(torch, np, kv, models, train, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
