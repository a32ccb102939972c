"""A cell over ``chips`` ranks: one process of the harness per card.

``run.py`` calls :func:`run` for a cell with ``chips`` above 1 (a one-card
cell never imports this module). The launcher starts ``chips`` processes,

    python3 -m benchlib.ranks <spec.json> <rank>

rank ``r`` on ``cuda:r``. They join an NCCL group for the program's own
collectives (gloo on the CPU, as the tests run it) and a gloo group for the
harness's, both on a store at a free port on localhost with a collective
timeout. Each rank builds its part of the program (:class:`World` is what
the harness hands it), and rank 0 decides each step whether the window goes
on and tells the others over the gloo group, a CPU tensor, so that no
decision waits for the device. Rank 0 runs the reference alone once the
others have handed over their readings, and writes the result's line to the
launch's directory.

The launcher waits under a limit of its own (set-up, the window and the
check): when a rank fails, or the limit passes, it kills every rank and
prints no line. Otherwise it prints rank 0's line, as a one-card run
prints its own. A rank exits 3 when it loaded JAX or the JAX package, and
so does the launcher then. ``setup_s`` counts from the launcher's start to
rank 0's first timed step, on the system-wide monotonic clock.
"""
from __future__ import annotations

import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from . import result

BENCH = Path(__file__).resolve().parents[1]
SETUP_LIMIT_S = 900         # a first run in a checkout builds the kernels
CHECK_LIMIT_S = 240         # the gathering and the reference after the window
COLLECTIVE_S = 600          # one collective, the first waiting on the builds
POLL_S = 0.2
EXIT_JAX = 3                # a rank loaded JAX or the JAX package


class World:
    """This rank's place among ``size`` ranks: ``group`` carries the
    program's collectives, ``ctl`` (gloo, CPU tensors) the harness's."""

    def __init__(self, rank: int, size: int, group, ctl):
        self.rank, self.size, self.group, self.ctl = rank, size, group, ctl

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank."""
        t = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.ctl)
        return bool(t[0])

    def barrier(self) -> None:
        dist.barrier(group=self.ctl)

    def gather(self, obj):
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.ctl)
        return out

    def _reduce(self, values, op, dtype):
        t = torch.tensor(values, dtype=dtype)
        dist.all_reduce(t, op=op, group=self.ctl)
        return t.tolist()

    def sum(self, values: list) -> list:
        return self._reduce(values, dist.ReduceOp.SUM, torch.int64)

    def max(self, values: list) -> list:
        return self._reduce(values, dist.ReduceOp.MAX, torch.int64)

    def mean(self, value: float) -> float:
        total = self._reduce([value], dist.ReduceOp.SUM, torch.float64)[0]
        return total / self.size


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def run(files, cell: dict, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", limit_s: float = None,
        collective_s: float = COLLECTIVE_S) -> int:
    """Launch ``cell`` over ``cell["chips"]`` ranks and print rank 0's
    result line; returns the exit code. ``t_start`` is the run's start on
    ``time.perf_counter``; ``limit_s`` bounds the whole launch."""
    world = cell["chips"]
    launched = time.monotonic() - (time.perf_counter() - t_start)
    if limit_s is None:
        limit_s = SETUP_LIMIT_S + seconds + CHECK_LIMIT_S
    deadline = launched + limit_s
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(BENCH), str(BENCH.parent), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        spec = Path(tmp) / "spec.json"
        spec.write_text(json.dumps({
            "bench": files.bench, "roots": [str(r) for r in files.roots],
            "workload": cell["name"], "seed": seed, "seconds": seconds,
            "trace": trace, "device": device, "world": world,
            "port": _free_port(), "launched": launched,
            "collective_s": collective_s, "parent": os.getpid(),
            "out": str(Path(tmp) / "line.json")}))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "benchlib.ranks", str(spec), str(r)],
            env=env, cwd=BENCH.parent, stdout=2)
            for r in range(world)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c]
                if bad or None not in codes:
                    break
                if time.monotonic() > deadline:
                    bad = [(r, "over the launch's limit of "
                            f"{limit_s:.0f} s") for r, c in enumerate(codes)
                           if c is None]
                    break
                time.sleep(POLL_S)
        finally:
            _stop(procs)
        out = Path(tmp) / "line.json"
        if bad or not out.is_file():
            print(f"{cell['name']}: ranks {bad or 'all'} failed or left no "
                  "result: no result", file=sys.stderr)
            return EXIT_JAX if any(c == EXIT_JAX for _, c in bad) else 1
        line = json.loads(out.read_text())
    found = result.forbidden_modules()
    if found:
        print(f"loaded JAX or the JAX package: {found}: no result",
              file=sys.stderr)
        return EXIT_JAX
    result.emit(line)
    return 0


def _die_with_parent(parent: int) -> None:
    """Be killed when the launcher dies, whatever ends it (Linux)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def rank_main(spec_path: str, rank: int) -> int:
    """One rank's process."""
    spec = json.loads(Path(spec_path).read_text())
    _die_with_parent(spec["parent"])
    from . import runner
    from .files import Files
    torch.set_num_threads(1)
    on_card = spec["device"] == "cuda"
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=spec["collective_s"])
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{spec['port']}",
        world_size=spec["world"], rank=rank, timeout=timeout)
    try:
        world = World(rank, spec["world"], dist.group.WORLD,
                      dist.new_group(backend="gloo", timeout=timeout))
        files = Files(spec["bench"], roots=spec["roots"])
        t_start = time.perf_counter() - (time.monotonic() - spec["launched"])
        out = runner.run(files, files.cell(spec["workload"]), spec["seed"],
                         spec["seconds"], spec["trace"], device, t_start,
                         world=world)
    finally:
        dist.destroy_process_group()
    found = result.forbidden_modules()
    if found:
        print(f"rank {rank} loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return EXIT_JAX
    if rank == 0:
        dev = {"platform": "gpu",
               "kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
               "count": spec["world"],
               "memory_peak_bytes": out["memory_peak_bytes"]}
        if spec["trace"]:
            dev.update(busy_s=out["busy_s"], window_s=out["window_s"])
        Path(spec["out"]).write_text(json.dumps(result.line(out, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
