"""The run's last line and the checks printed beside it."""
from __future__ import annotations

import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tfplus_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's: ``tfplus_tpu_torch`` passes,
    ``tfplus_tpu`` and ``tfplus_tpu.kv`` do not."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def line(result: dict, device: dict) -> dict:
    """The contract's keys in order, ``checks`` last."""
    out = {"correct": bool(result["correct"]),
           "attempted": result["attempted"], "failed": result["failed"],
           "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    return out


def emit(out: dict, err=None, stream=None) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    err = sys.stderr if err is None else err
    stream = sys.stdout if stream is None else stream
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(out), file=stream)
    stream.flush()
