#!/usr/bin/env python3
"""Profile BST training (or serving) at published widths from one
checkout, on one CUDA card.

    python3 scripts/bst_training_profile.py CHECKOUT OUT_DIR [--serving]

Runs ``chip_smoke.py``'s BST training phase (the item and user tables with
Adam's slots, batch-2048 steps, the launch counts it expects per step)
from the checkout at CHECKOUT with ``torch.profiler`` on, and writes the
table of ops and kernels to OUT_DIR. It prints the phase's examples/s and
the profiled device ms per step. With ``--serving`` it runs the BST and
DIN serving phase instead (batch-2048 requests on the same tables) and
prints examples/s and device ms per request. Runs from two checkouts in
turns in one call (A, B, B, A) compare two versions on one card.
"""
import os
import sys


def main() -> int:
    serving = "--serving" in sys.argv[3:]
    if len(sys.argv) != 3 + serving:
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
    from tfplus_tpu_torch import embedding, kv, models, train
    if serving:
        print(f"BST and DIN serving from {sys.argv[1]}", flush=True)
        chip_smoke.sequence_serving_phase(torch, np, kv, embedding, models,
                                          out_dir)
    else:
        print(f"BST training from {sys.argv[1]}", flush=True)
        chip_smoke.bst_training_phase(torch, np, kv, models, train, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
