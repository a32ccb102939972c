"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``tfplus_tpu_torch``. A run sets the
cell up from the seed (tables, weights, traffic; set-up counts from the
start of this script to the first timed step), measures for ``--seconds``
(``--trace 1``: profiles a bounded stretch and reports the per-layer
metrics), checks the outputs against the plain reference, and prints one
JSON line. It needs as many CUDA devices as the cell asks for; without them
it exits with 2 and prints no result, as it does (with 3) when JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
# one process with one CPU thread: the steps are host-bound launches, and a
# shared host's other threads only add to the spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(BENCH), str(ROOT)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    from benchlib import files, result, runner
    cells = files.Files(bench)
    cell = cells.cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    out = runner.run(cells, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    bad = result.forbidden_modules()
    if bad:
        print(f"loaded JAX or the JAX package: {bad}: no result",
              file=sys.stderr)
        return 3
    result.emit(result.line(out, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
