"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
chip at the cell's own size, several seeds in one process:

    python3 benchmarks/readings.py --workload <cell> --seeds 1 2 3 \
        [--override '{"keys_per_table": 262144}']

For each seed it builds the cell as a run does and prints one JSON line with
the numbers the run compares for the program, and the same numbers for the
control (the reference in float32 with TF32 products, put in the program's
place) and, for a training cell, for a planted fault (the reference with
the loss over half of the batch). Every number is a gap against the float64
reference. A training line also counts the ids of the first steps that the
program's tables do not hold afterwards. A cell whose ``chips`` N is above
1 runs as N ranks through ``benchlib/ranks.py``'s launcher, as ``run.py``
runs it: each seed's program is built over the ranks, its readings are
gathered to rank 0, which runs the references and prints the lines; if a
rank fails or hangs, every rank is killed and no line is printed. The
benchmark's own runs never run this; it is how the limits were found (see
PERF.md).
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def missing_ids(prog, n):
    """For each id of the first ``n`` steps that a table does not hold (in
    a world of several ranks, of those this rank's shards own): whether it
    was fresh, and how many of the 16 lanes of its two buckets hold an id
    (both full: the insert had nowhere to go)."""
    import numpy as np
    import torch
    from benchlib import inputs
    kv = prog.tp.kv
    out = {}
    for name in prog.tables:
        ids = prog._mine(np.unique(np.concatenate(
            [prog.traffic.batch(s)["ids"][name] for s in range(n)])))
        table = prog.state.tables[name]
        q = inputs.encode(torch.from_numpy(ids).to(prog.device))
        bad = ~kv.find(table, q).found
        if not bool(bad.any()):
            continue
        ids, q = ids[bad.cpu().numpy()], q[bad]
        lanes = []
        for b in kv.hashing.bucket_choices(q, table.capacity):
            words = table.header[b][:, :32]
            lanes.append((~kv.hashing.is_free(torch.stack(
                [words[:, :16], words[:, 16:]], -1))).sum(1).tolist())
        out[name] = [{"fresh": bool(i >= inputs.FRESH_BASE),
                      "lanes_used": [a, b]}
                     for i, a, b in zip(ids.tolist(), *lanes)]
    return out


def _merge(names, parts: list) -> dict:
    """Each rank's ``missing_ids`` as one: tables in ``names``' order, each
    table's ids in rank order."""
    return {name: [i for part in parts for i in part.get(name, [])]
            for name in names if any(name in part for part in parts)}


def readings(files, cell, seed, override, device, world=None):
    """One seed's readings, or None on a rank other than 0 of ``world``."""
    import torch
    from benchlib import compare
    from benchlib.program import SparseProgram
    from benchlib.runner import Loop
    cfg = dict(files.config(cell["config"]), **override)
    mix = files.traffic(cell["traffic"])
    prog = SparseProgram(files.model(cell["config"]), cfg, mix, seed, device,
                         world)
    out = {"cell": cell["name"], "seed": seed, "override": override}
    if prog.train:
        n = mix["check_steps"]
        got = prog.check_steps(n)
        out["missing_ids"] = missing_ids(prog, n)
        if world is not None:
            parts = world.gather(out["missing_ids"])
            out["missing_ids"] = (None if parts is None
                                  else _merge(prog.tables, parts))
        out["fill_unplaced"] = prog.unplaced
        prog.release()
        if world is not None and world.rank:
            out = None
        else:
            ref = compare.reference_training(prog, n)
            out["losses"] = {"program": got["losses"],
                             "reference": ref["losses"]}
            for name, other in (
                    ("program", got),
                    ("reference_f32",
                     compare.reference_training(prog, n,
                                                dtype=torch.float32)),
                    ("control_tf32",
                     compare.reference_training(prog, n, dtype=torch.float32,
                                                tf32=True)),
                    ("fault_half_batch",
                     compare.reference_training(
                         prog, n, loss_rows=mix["batch"] // 2))):
                gaps, worst = compare.train_gaps(other, ref)
                out[name] = gaps
                out[name + "_worst"] = worst
    else:
        loop = Loop(prog, 0)
        for _ in range(mix["check_requests"]):
            loop.one()
        served = dict(loop.preds)
        out["fill_unplaced"] = prog.unplaced
        prog.release()
        ref = compare.reference_serving(prog, sorted(served))
        ctl = compare.reference_serving(prog, sorted(served),
                                        dtype=torch.float32, tf32=True)
        f32 = compare.reference_serving(prog, sorted(served),
                                        dtype=torch.float32)
        out["program"] = {"pred": max(compare.pred_gap(served[s], ref[s])
                                      for s in served)}
        out["reference_f32"] = {"pred": max(
            compare.pred_gap(f32[s].numpy(), ref[s]) for s in served)}
        out["control_tf32"] = {"pred": max(
            compare.pred_gap(ctl[s].numpy(), ref[s]) for s in served)}
    del prog
    gc.collect()
    if torch.device(device).type != "cpu":
        torch.cuda.empty_cache()
    if world is not None:
        world.barrier()     # the next seed starts on every rank together
    return out


def lines(files, cell, seeds, override, device, world=None):
    """One JSON line a seed (on rank 0 of ``world``; none elsewhere)."""
    for seed in seeds:
        t0 = time.perf_counter()
        out = readings(files, cell, seed, override, device, world)
        if out is None:
            continue
        out["seconds"] = time.perf_counter() - t0
        yield json.dumps(out, default=lambda x: None if isinstance(
            x, float) and not math.isfinite(x) else str(x))


def main(argv=None, files=None, **launch) -> int:
    """``files`` (a ``benchlib.files.Files``) and ``launch`` (the limits of
    ``benchlib.ranks.readings``) let a test read cells of its own files."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--override", default="{}")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if files is None:
        from benchlib.files import Files
        with open(ROOT / "BENCHMARK.json") as f:
            files = Files(json.load(f))
    cell = files.cell(args.workload)
    override = json.loads(args.override)
    if cell["chips"] > 1:
        import torch
        if args.device == "cuda" and \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA devices",
                  file=sys.stderr)
            return 2
        from benchlib import ranks
        code, out = ranks.readings(files, cell, args.seeds, override,
                                   args.device, **launch)
        for line in out or []:
            print(line, flush=True)
        return code
    for line in lines(files, cell, args.seeds, override, args.device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
