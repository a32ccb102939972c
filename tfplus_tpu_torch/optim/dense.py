"""Dense twins of the sparse optimizer rules.

Counterpart of ``tfplus_tpu/optim/dense.py`` (``as_optax``): every sparse
:class:`~tfplus_tpu_torch.optim.rules.Rule` doubles as a dense update by
treating a parameter as its own batch of rows, here as a
``torch.optim.Optimizer`` so that dense towers can use the in-house rules.
"""
from __future__ import annotations

import torch

from .rules import Rule


def _rowify(x: torch.Tensor):
    """View a parameter as an ``[N, D]`` row batch (D = trailing dim;
    scalars and vectors become one row)."""
    if x.ndim == 0:
        return x.reshape(1, 1), x.shape
    if x.ndim == 1:
        return x.reshape(1, -1), x.shape
    return x.reshape(-1, x.shape[-1]), x.shape


class DenseRule(torch.optim.Optimizer):
    """A rule applied to dense parameters, as the JAX package's
    ``as_optax(rule, learning_rate)``: one global step for all parameters,
    a missing gradient counts as zeros, each parameter's slots are
    ``[rows, k·D]`` in its own dtype, and the parameter moves by
    ``new − p`` (optax's ``apply_updates``)."""

    def __init__(self, params, rule: Rule, lr: float):
        super().__init__(params, dict(lr=lr))
        self.rule = rule
        self.global_step = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.global_step += 1
        for group in self.param_groups:
            for p in group["params"]:
                rows, shape = _rowify(p)
                st = self.state[p]
                if "slots" not in st:
                    st["slots"] = rows.new_zeros(
                        (rows.shape[0], self.rule.slot_width * rows.shape[1]))
                g = torch.zeros_like(p) if p.grad is None else p.grad
                new_rows, st["slots"], _ = self.rule.update(
                    rows, st["slots"], _rowify(g)[0], lr=group["lr"],
                    step=torch.tensor(self.global_step, dtype=torch.int32))
                p.add_(new_rows.reshape(shape) - p)
        return loss


def as_optimizer(rule: Rule, learning_rate: float):
    """A factory ``params -> DenseRule`` (the port's form of ``as_optax``,
    for ``models.init_state``'s ``dense_tx``)."""
    return lambda params: DenseRule(params, rule, learning_rate)
