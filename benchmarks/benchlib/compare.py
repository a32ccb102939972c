"""The comparison that decides ``correct``, and the view the per-layer
readers get of a traced stretch.

Training: the reference follows the run's first steps from the same weights,
rows and batches, in float64. The numbers: each step's loss (relative gap);
per leaf (each dense parameter, each table over the ids the steps touched)
the norm of the first gradient and the norm of the change after the steps,
each as the gap between the program's norm and the reference's over the
larger of the reference's norm of that leaf and of the median leaf, worst
leaf or median leaf taken. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change. ``limits/<cell>.json`` names the numbers a cell compares.

Serving: sampled requests' predictions against the reference's, each
gap over the request's rms logit plus the logit's own size, worst taken.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import statistics
from typing import Optional

import numpy as np
import torch

from reference import sparse as ref_sparse

QUIET_SHARE = 1e-3


@dataclasses.dataclass
class View:
    """What a per-layer reader reads: the traced stretch and the work its
    steps or requests needed."""
    kind: str                   # "train" or "serve"
    trace: object               # benchlib.trace.Trace
    steps: int
    flops: float                # model operations of the traced steps
    rows_bytes: float           # bytes the row kernels needed
    attention_bound_s: Optional[float]
    peak_flops: float


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for float32 products, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def forward_of(prog):
    family = importlib.import_module(f"reference.{prog.adapter.FAMILY}")
    return family.make_forward(prog.cfg)


def reference_training(prog, n: int, *, dtype=torch.float64, tf32=False,
                       loss_rows=None) -> dict:
    """The reference's readings over the run's first ``n`` steps."""
    batches = [prog.traffic.feed(prog.traffic.batch(s)) for s in range(n)]
    with precision(tf32):
        out = ref_sparse.train(
            forward_of(prog), prog.weights, batches,
            prog.row_source("fresh"), prog.cfg["sparse_optimizer"],
            prog.cfg["dense_optimizer"], dtype=dtype,
            device=prog.device, loss_rows=loss_rows)
    out["grads"] = {k: v.double().cpu() for k, v in out["grads"].items()}
    out["final"] = {k: v.double().cpu() for k, v in out["final"].items()}
    out["initial"] = {k: v.double().cpu() for k, v in out["initial"].items()}
    return out


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def train_gaps(got: dict, ref: dict) -> tuple:
    """The training numbers: ``missing``, the ids the steps touched that
    the tables do not hold afterwards; gaps, each the worst (``loss`` over
    the steps, ``grad`` and ``change`` over the leaves) and its steadier
    form (``loss1``: step 1 alone; ``*_median``: the median leaf's); and
    the worst leaves by name."""
    losses = [_nan_high(abs(a - b) / abs(b))
              for a, b in zip(got["losses"], ref["losses"])]
    gr = {k: _norm(v) for k, v in ref["grads"].items()}
    med = statistics.median(gr.values())
    grad = {k: _nan_high(abs(_norm(got["grads"][k]) - gr[k])
                         / max(gr[k], med)) for k in gr}
    kept = [k for k in gr if gr[k] >= QUIET_SHARE * med]
    dr = {k: _norm(ref["final"][k] - ref["initial"][k]) for k in kept}
    dmed = statistics.median(dr.values())
    change = {k: _nan_high(abs(_norm(got["final"][k] - ref["initial"][k])
                               - dr[k]) / max(dr[k], dmed)) for k in kept}
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    missing = sum(int((~torch.isfinite(v).all(dim=1)).sum())
                  for k, v in got["final"].items() if k.startswith("table:"))
    return ({"missing": float(missing),
             "loss": max(losses), "loss1": losses[0],
             "grad": grad[worst_g],
             "grad_median": statistics.median(grad.values()),
             "change": change[worst_c],
             "change_median": statistics.median(change.values())},
            {"grad": worst_g, "change": worst_c,
             "left_out": sorted(set(gr) - set(kept))})


def _nan_high(x: float) -> float:
    return math.inf if not math.isfinite(x) else x


def training(prog, readings: dict, limits: dict) -> dict:
    ref = reference_training(prog, len(readings["losses"]))
    gaps, _ = train_gaps(readings, ref)
    return {k: {"value": gaps[k], "limit": limit}
            for k, limit in limits.items()}


def reference_serving(prog, indices, *, dtype=torch.float64,
                      tf32=False) -> dict:
    fwd = forward_of(prog)
    rows = prog.row_source("zero")
    out = {}
    with precision(tf32):
        for s in indices:
            b = prog.traffic.feed(prog.traffic.batch(s))
            out[s] = ref_sparse.predict(fwd, prog.weights, b, rows,
                                        dtype=dtype,
                                        device=prog.device).double().cpu()
    return out


def pred_gap(got: np.ndarray, ref: torch.Tensor) -> float:
    ref = ref.numpy()
    rms = float(np.sqrt(np.mean(ref * ref)))
    gap = np.abs(np.asarray(got, dtype=np.float64).reshape(ref.shape) - ref)
    return _nan_high(float(np.max(gap / (rms + np.abs(ref)))))


def serving(prog, served: dict, limits: dict) -> dict:
    if not served:
        return {"pred": {"value": math.inf, "limit": limits["pred"]}}
    ref = reference_serving(prog, sorted(served))
    worst = max(pred_gap(served[s], ref[s]) for s in served)
    return {"pred": {"value": worst, "limit": limits["pred"]}}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
