"""Build the port's CUDA kernels at first use and load them through ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``tfplus_tpu_torch/_build/`` (listed
in ``.gitignore``). A library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source builds
anew and an unchanged one is reused. ``-Xptxas -v`` keeps each kernel's
registers, shared memory and spills in ``<library>.log`` beside it
(:func:`ptxas_report`). Only sources in this package are compiled.
Importing this module needs no ``nvcc``; :func:`build_all` or the first
:func:`library` call does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put nvcc on PATH or set CUDA_HOME)")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns ``{name: path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        so = _target(src)
        out[src.stem] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        running.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return lib


def ptxas_report(name: str) -> list:
    """``ptxas``'s lines for the kernels of ``csrc/<name>.cu`` as built (one
    "Compiling entry function" line, then its registers, shared memory and
    spill counts), from the log kept beside the library."""
    log = build_all()[name].with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if ("ptxas info" in ln and ("Compiling" in ln or "Used" in ln))
            or "spill" in ln]
