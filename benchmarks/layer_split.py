"""Where a cell's traced stretch idles, by the program's own layers, on the
chip at the cell's own size, several seeds in one process:

    python3 benchmarks/layer_split.py --workload <cell> --seeds 1 2 3 \
        [--steps K]

For each seed it sets the cell up as a run does, traces one stretch as a
``--trace 1`` run does (``--steps``: exactly K steps or requests, the same
ones on any checkout, so that two checkouts' counts compare step for
step), and prints one JSON line: the stretch's steps, length and rate,
the device's idle time and the program's synchronize calls split by layer
(``benchlib.spans``; ``null``: outside any layer) beside the trace's own
totals, the claim rounds, and the ``tfp::`` spans per step by name. The benchmark's own runs never run this; it is how
PERF.md's layer breakdowns were read.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def split_line(files, cell, seed, device, exact=None):
    import torch
    from benchlib import runner, spans
    from benchlib.program import SparseProgram
    mix = files.traffic(cell["traffic"])
    prog = SparseProgram(files.model(cell["config"]),
                         files.config(cell["config"]), mix, seed, device)
    first = 0
    if prog.train:
        prog.check_steps(mix["check_steps"])
        first = mix["check_steps"]
    loop = runner.Loop(prog, first)
    for _ in range(mix["warmup_steps"]):
        loop.one()
    torch.cuda.synchronize(device)
    loop.clear()
    indices, tr = (runner.traced(loop, 0.0, exact) if exact else
                   runner.traced(loop, mix["trace_seconds"],
                                 mix["trace_min_steps"]))
    steps = len(indices)
    s = spans.split(tr)
    idle_us = (tr.hi - tr.lo) - 1e6 * tr.busy_s
    names = Counter(e[2] for e in (spans.step_spans(tr) or []))
    out = {"cell": cell["name"], "seed": seed, "steps": steps,
           "window_s": tr.window_s, "busy_s": tr.busy_s,
           "examples_per_s": steps * mix["batch"] / tr.window_s,
           "idle_ms": idle_us / 1e3, "syncs": tr.syncs,
           "launches": tr.launches}
    if s is not None:
        out.update(
            idle_ms_by_layer={str(k): v / 1e3
                              for k, v in s["idle_us"].items()},
            syncs_by_layer={str(k): v for k, v in s["syncs"].items()},
            idle_in_layers=1 - s["idle_us"].get(None, 0.0) / idle_us,
            idle_sum_error_ms=(sum(s["idle_us"].values()) - idle_us) / 1e3,
            syncs_sum_error=sum(s["syncs"].values()) - tr.syncs,
            claim_rounds=s["claim_rounds"],
            spans_per_step={k: v / steps for k, v in sorted(names.items())})
    prog.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=None)
    args = p.parse_args(argv)
    from benchlib.files import Files
    with open(ROOT / "BENCHMARK.json") as f:
        files = Files(json.load(f))
    cell = files.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = split_line(files, cell, seed, "cuda", args.steps)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
