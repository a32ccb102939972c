#!/usr/bin/env python3
"""Three measurements of the row kernels on one CUDA card that
``chip_smoke.py`` does not make.

    python3 scripts/rowops_probe.py [--reps N] [--out FILE]

Run from the root of a checkout. Every time is the median of ``--reps``
CUDA-event timings from a cold L2, the functions of one measurement taking
turns (``chip_smoke.time_turns``, the method of the kernels line):

- ``floor_ms``: what a launch costs whatever its work: a kernel that does
  nothing (``torch.cuda._sleep(1)``) and each wrapper on one row of a
  2^20-row f32 width-64 table;
- ``host_us_per_call``: the host's time to enqueue one call (no
  synchronisation), median of 5 runs of 200 calls: the wrappers on 2,048
  rows of that table, and ``index_select`` on the same rows;
- ``red_add``: f32 scatter-add into a 2^20-row table at the narrow rows and
  counts the paths give it, three ways on the same inputs: the port's kernel
  (``scatter_rows(add=True)``: it reads the destination, adds and stores),
  ``scripts/rowops_red_add.cu`` (the same lanes, adding with
  ``red.global.add.f32`` and no read) and ``index_add_``. The first two are held bit for bit against the plain
  version on random rows first; ``flushes_subnormals`` says whether each
  adds two subnormals (2^-130 + 2^-130) to 0 instead of 2^-129, as the
  plain version on the CPU does.

The script builds ``rowops_red_add.cu`` with the package's ``nvcc`` flags
into ``tfplus_tpu_torch/_build/``. It prints one line per measurement and
then one JSON line (the card's name and power limit first), written to
``--out`` instead where one is given.
"""
import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

C_ROWS = 1 << 20
RED_SHAPES = [(1, 1 << 15), (3, 1 << 15), (3, 2048), (16, 2048),
              (64, 2048), (64, 1 << 15)]
RED_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rowops_red_add.cu")


def red_library():
    """``rowops_red_add.cu`` built (once per source and flags) and typed."""
    from tfplus_tpu_torch.ops import _build
    with open(RED_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_build.NVCC_FLAGS).encode())
    so = _build.BUILD_DIR / f"rowops_red_add-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                        RED_SOURCE], check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.tfp_scatter_add_red.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    lib.tfp_scatter_add_red.restype = ctypes.c_int
    return lib


def red_add(torch, lib, values, idx, rows):
    err = lib.tfp_scatter_add_red(
        values.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
        values.shape[0], values.shape[1],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tfp_scatter_add_red failed: cudaError {err}")
    return values


def floor(torch, chip_smoke, rowops, reps):
    values = torch.randn(C_ROWS, 64, device="cuda")
    one = torch.tensor([12345], dtype=torch.int32, device="cuda")
    row = torch.randn(1, 64, device="cuda")
    return chip_smoke.time_turns(torch, {
        "empty_kernel": lambda: torch.cuda._sleep(1),
        "gather_one_row": lambda: rowops.gather_rows(values, one),
        "scatter_set_one_row": lambda: rowops.scatter_rows(values, one, row),
        "scatter_add_one_row": lambda: rowops.scatter_rows(values, one, row,
                                                           add=True)}, reps)


def host_us(torch, rowops, calls=200, reps=5):
    values = torch.randn(C_ROWS, 64, device="cuda")
    idx = torch.randint(0, C_ROWS, (2048,), device="cuda", dtype=torch.int32)
    rows = torch.randn(2048, 64, device="cuda")
    out = {}
    for name, fn in (("gather_rows", lambda: rowops.gather_rows(values, idx)),
                     ("scatter_rows",
                      lambda: rowops.scatter_rows(values, idx, rows)),
                     ("index_select",
                      lambda: torch.index_select(values, 0, idx))):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = statistics.median(runs)
    return out


def flushes_subnormals(torch, add):
    """Whether ``add(values, idx, rows)`` on the card turns 2^-130 + 2^-130
    into 0 (the plain version on the CPU gives 2^-129)."""
    tiny = 2.0 ** -130
    values = torch.full((4, 1), tiny, device="cuda")
    rows = torch.full((2, 1), tiny, device="cuda")
    idx = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    got = add(values, idx, rows).cpu()
    return bool(got[1, 0] == 0 and got[2, 0] == 0)


def red_phase(torch, chip_smoke, rowops, lib, reps):
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for width, n in RED_SHAPES:
        values = torch.randn(C_ROWS, width, device="cuda", generator=gen)
        rows = torch.randn(n, width, device="cuda", generator=gen)
        idx = (torch.randperm(C_ROWS + 64, device="cuda", generator=gen)[:n]
               - 32).to(torch.int32)
        keep = (idx >= 0) & (idx < C_ROWS)
        kept_idx, kept_rows = idx[keep].long(), rows[keep]
        want = rowops.scatter_rows_plain(values.clone(), idx, rows, add=True)
        for name, fn in (("kernel", lambda v: rowops.scatter_rows(
                v, idx, rows, add=True)),
                         ("red", lambda v: red_add(torch, lib, v, idx,
                                                   rows))):
            got = fn(values.clone())
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"red_add w{width} n{n}: {name} differs "
                                     "from the plain version")
        target = values.clone()
        times = chip_smoke.time_turns(torch, {
            "kernel": lambda: rowops.scatter_rows(target, idx, rows,
                                                  add=True),
            "red": lambda: red_add(torch, lib, target, idx, rows),
            "index_add_": lambda: target.index_add_(0, kept_idx, kept_rows)},
            reps)
        out[f"float32_w{width}_n{n}"] = times
        print(f"red_add f32 w{width} n{n}: " + ", ".join(
            f"{k} {v * 1e3:.3f} us" for k, v in times.items()), flush=True)
        del values, target, rows
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", help="write the JSON line here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rowops_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from tfplus_tpu_torch.ops import rowops
    lib = red_library()
    result = {"device": chip_smoke.smi_line(), "reps": args.reps,
              "floor_ms": floor(torch, chip_smoke, rowops, args.reps),
              "host_us_per_call": host_us(torch, rowops)}
    print("floor ms", json.dumps(result["floor_ms"]), "host us per call",
          json.dumps(result["host_us_per_call"]), flush=True)
    result["flushes_subnormals"] = {
        "kernel": flushes_subnormals(
            torch, lambda v, i, r: rowops.scatter_rows(v, i, r, add=True)),
        "red": flushes_subnormals(
            torch, lambda v, i, r: red_add(torch, lib, v, i, r)),
        "index_add_": flushes_subnormals(
            torch, lambda v, i, r: v.index_add_(0, i.long(), r))}
    print("flushes subnormals", json.dumps(result["flushes_subnormals"]),
          flush=True)
    result["red_add_ms"] = red_phase(torch, chip_smoke, rowops, lib,
                                     args.reps)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    else:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
