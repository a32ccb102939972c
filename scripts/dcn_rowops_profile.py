#!/usr/bin/env python3
"""Profile the row kernels' device time in DCN serving and training at the
reference width, from one checkout, on one CUDA card.

    python3 scripts/dcn_rowops_profile.py CHECKOUT OUT_DIR

Runs ``chip_smoke.py``'s DCN serving phase (26 tables of 2^20 rows filled
with 2^19 keys each, batch-2048 requests) and DCN training phase (the same
tables with GroupAdam's slot columns, batch-2048 steps) from the checkout
at CHECKOUT with ``torch.profiler`` on, through this script's copy of
``chip_smoke.profile_calls``: per request and per step it prints the
device ms of all kernels and of the row kernels (every kernel whose name
holds ``rows_kernel``: the earlier ``gather_rows_kernel`` and
``scatter_rows_kernel``, and the redesigned ``rows_kernel``) and their
launches, and writes the tables of ops and kernels to OUT_DIR. Runs from
two checkouts in turns in one call (A, B, B, A) compare two versions of
the row kernels on one card.
"""
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, out_dir = os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dcn_rowops_profile: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from tfplus_tpu_torch import embedding, kv, models, train
    from tfplus_tpu_torch.ops import rowops
    chip_smoke.profile_calls = here.profile_calls
    print(f"DCN serving and training from {sys.argv[1]}", flush=True)
    chip_smoke.dcn_serving_phase(torch, np, kv, embedding, models, rowops,
                                 out_dir)
    chip_smoke.dcn_training_phase(torch, np, kv, models, train, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
