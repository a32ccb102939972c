"""Sparse optimizer row-update rules.

Counterpart of ``tfplus_tpu/optim/rules.py``, with the same math written
in PyTorch: each rule is a pure function over the batch of unique touched
rows ``[N, D]`` plus one concatenated slot array ``[N, k*D]``; the gather
and scatter around it live in :mod:`tfplus_tpu_torch.optim.base`.

What is kept exactly as in the JAX package:

* ``beta ** step`` is computed as ``exp(step * ln(beta))`` with ``ln(beta)``
  rounded to the step's dtype first (:func:`_const_base_pow`), never with
  ``pow``, which rounds differently;
* the step-1 branches (GroupAdam's ``sigma``, AdaDQH's ``beta``/``gamma``);
* the group-lasso solve returns the blacklist mask with the new rows.

Scalars (betas, lr) combine with float32 tensors as JAX's weakly typed
Python scalars do: rounded to float32, then one float32 operation.

The group rules' ``norm_axis`` is the process group of the column shards
of 2D table sharding (``parallel.sharded2d.for_col_axis`` sets it): the
squared group norm is all-reduced over it and the l21 threshold uses the
global dim, so that every column shard makes the same keep/blacklist
decision, as the JAX package's ``psum`` over the column axis does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

Arr = torch.Tensor
_TINY = 1e-30


def _norm(x: Arr, group=None) -> Arr:
    s = torch.sum(x * x, dim=-1)
    if group is not None:
        # dim-sharded rows (2D table sharding): the group norm spans every
        # column shard, so the squared partials are summed over the group
        dist.all_reduce(s, group=group)
    return torch.sqrt(s)


def _f32(x, like: Arr) -> Arr:
    """A Python number as a 0-d tensor of ``like``'s dtype and device."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _group_lasso_solve(linear: Arr, y: Arr, l1, l2, l21, dim: int,
                       norm_axis=None) -> Tuple[Arr, Arr]:
    """Closed-form group-lasso solve (training_ops.cc:1301-1317).

    ``y`` is the per-element curvature denominator WITHOUT the ``2*l2``
    term. Returns ``(var, blacklist_mask)``; blacklisted rows are zero.
    ``norm_axis``: the process group holding the column shards of the row
    (2D sharding); the threshold then uses the GLOBAL dim and the
    all-reduced norm."""
    if norm_axis is not None:
        dim = dim * dist.get_world_size(norm_axis)
    adj = torch.clamp(linear, -l1, l1)
    l1_linear = adj - linear
    nrm = _norm(l1_linear, norm_axis)
    l21n = l21 * torch.sqrt(_f32(float(dim), linear))
    keep = nrm > l21n
    scale = 1.0 - l21n / torch.clamp(nrm, min=_TINY)
    var = l1_linear * scale[:, None] / (y + 2.0 * l2)
    var = torch.where(keep[:, None], var, torch.zeros_like(var))
    return var, ~keep


def _split(state: Arr, k: int) -> list:
    d = state.shape[-1] // k
    return [state[..., i * d:(i + 1) * d] for i in range(k)]


def _const_base_pow(base, t: Arr) -> Arr:
    """``base ** t`` for a concrete scalar base and a tensor exponent, as
    ``exp(t·ln base)`` with ``ln base`` rounded to ``t``'s dtype (the JAX
    package's form, which Mosaic needed; kept for bit-level parity)."""
    b = float(base)
    if b == 1.0:
        return torch.ones_like(t)
    if b <= 0.0:                       # not reachable from the shipped rules
        return _f32(b, t) ** t
    return torch.exp(t * _f32(math.log(b), t))


def _step(step, like: Arr) -> Arr:
    """The 1-indexed step as a tensor on ``like``'s device."""
    return torch.as_tensor(step, device=like.device)


def _powers(beta1, beta2, step, like: Arr):
    t = _step(step, like).to(like.dtype)
    return _const_base_pow(beta1, t), _const_base_pow(beta2, t)


def _first(step, like: Arr) -> Arr:
    return _step(step, like).to(torch.int32) <= 1


class Rule:
    """Base: ``slot_width`` concat-slot multiplier k; state is [N, k*D]."""
    slot_width: int = 0
    #: rules that blacklist rows (group-lasso family)
    has_blacklist: bool = False
    #: rules that need an extra per-row input (e.g. AdaHessian's hessian)
    needs_extra: bool = False

    def update(self, var: Arr, state: Arr, grad: Arr, *, lr, step,
               extra: Optional[Arr] = None) -> Tuple[Arr, Arr, Optional[Arr]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sgd(Rule):
    """Plain scatter-sub of lr*grad (gradient_descent.py:24-31)."""
    slot_width = 0

    def update(self, var, state, grad, *, lr, step, extra=None):
        return var - lr * grad, state, None


@dataclasses.dataclass(frozen=True)
class Adagrad(Rule):
    """accum += g²; var -= lr·g/√accum (training_ops.cc:1455-1485). The slot
    stores ``accum - initial_accumulator_value``."""
    initial_accumulator_value: float = 0.1
    slot_width = 1

    def update(self, var, state, grad, *, lr, step, extra=None):
        accum = state + self.initial_accumulator_value + grad * grad
        var = var - lr * grad / torch.sqrt(accum)
        return var, accum - self.initial_accumulator_value, None


@dataclasses.dataclass(frozen=True)
class Adam(Rule):
    """Lazy Adam on touched rows, fused m|v slot (adam.py:93-163)."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    slot_width = 2

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v = _split(state, 2)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        var = var - lr_t * m / (self.epsilon + torch.sqrt(v))
        return var, torch.cat([m, v], dim=-1), None


@dataclasses.dataclass(frozen=True)
class GroupAdam(Rule):
    """GroupAdam V4 (training_ops.cc:6981-7236). Slot layout m|v|linear;
    l1/l2/l21 are scaled by lr inside (:7113-7115)."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 3
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, linear = _split(state, 3)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        l1 = self.l1 * lr
        l2 = self.l2 * lr
        l21 = self.l21 * lr
        alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)

        m = self.beta1 * m + (1.0 - self.beta1) * grad
        new_v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        nvs = torch.sqrt(new_v)
        # step 1 (beta1 <= beta1_power): sigma = nvs + eps; else Δ√v
        sigma = torch.where(_first(step, var), nvs + self.epsilon,
                            nvs - torch.sqrt(v))
        linear = linear + alpha * m - sigma * var
        y = nvs + self.epsilon
        new_var, black = _group_lasso_solve(linear, y, l1, l2, l21,
                                            var.shape[-1],
                                            norm_axis=self.norm_axis)
        return new_var, torch.cat([m, new_v, linear], dim=-1), black


@dataclasses.dataclass(frozen=True)
class GroupAdamV1(Rule):
    """GroupAdam version 1 (GroupSparseApplyAdamOp, training_ops.cc:1065):
    bias-corrected second moment in its own ``accum`` slot, unscaled
    l1/l2/l21. Slot layout m|v|accum|linear."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    initial_accumulator_value: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, accum0, linear = _split(state, 4)
        accum = accum0 + self.initial_accumulator_value
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        new_accum = v / (1.0 - b2p)
        eps_adj = self.epsilon / torch.sqrt(1.0 - b2p)
        delta = torch.sqrt(new_accum) - torch.sqrt(accum)
        delta = torch.where(_first(step, var), delta + eps_adj, delta)
        linear = linear + m / (1.0 - b1p) - delta / lr * var
        y = (torch.sqrt(new_accum) + eps_adj) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat(
            [m, v, new_accum - self.initial_accumulator_value, linear],
            dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupFtrl(Rule):
    """SparseGroupFtrl (+l2_shrinkage), training_ops.cc:533-805. Slot layout
    accum|linear; the slot stores ``accum - initial_accum``."""
    lr_power: float = -0.5
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    l2_shrinkage: float = 0.0
    initial_accumulator_value: float = 0.1
    slot_width = 2
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        accum0, linear = _split(state, 2)
        accum = accum0 + self.initial_accumulator_value
        g = grad
        if self.l2_shrinkage:
            g = grad + 2.0 * self.l2_shrinkage * var
        new_accum = accum + g * g
        if self.lr_power == -0.5:
            pw_new, pw_old = torch.sqrt(new_accum), torch.sqrt(accum)
        elif self.lr_power == 0.0:
            # x**0 == 1 exactly (exp(0·log 0) would be NaN at accum == 0)
            pw_new = torch.ones_like(new_accum)
            pw_old = torch.ones_like(accum)
        else:
            p = -float(self.lr_power)
            pw_new = torch.exp(p * torch.log(torch.clamp(new_accum,
                                                         min=_TINY)))
            pw_old = torch.exp(p * torch.log(torch.clamp(accum, min=_TINY)))
        linear = linear + g - (pw_new - pw_old) / lr * var
        y = pw_new / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat(
            [new_accum - self.initial_accumulator_value, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupMomentum(Rule):
    """GroupSparseApplyMomentum (training_ops.cc:2274). Slot layout
    m|accum|linear; accum is the 0→1 latch that makes the first step
    subtract var/lr."""
    momentum: float = 0.9
    use_nesterov: bool = False
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 3
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, accum, linear = _split(state, 3)
        m = m * self.momentum + grad
        new_m = m * self.momentum + grad if self.use_nesterov else m
        linear = linear + new_m - (1.0 - torch.sqrt(accum)) / lr * var
        y = 1.0 / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, torch.ones_like(accum), linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupAdadelta(Rule):
    """GroupSparseApplyAdadelta (training_ops.cc:2005). Slot layout
    accum|accum_update|linear."""
    rho: float = 0.95
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 3
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        accum, accum_update, linear = _split(state, 3)
        new_accum = accum * self.rho + (1.0 - self.rho) * grad * grad
        m = torch.sqrt(accum_update + self.epsilon) * grad
        linear = (linear + m
                  - (torch.sqrt(new_accum) - torch.sqrt(accum)) / lr * var)
        y = torch.sqrt(new_accum + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        accum_update = (accum_update * self.rho +
                        (1.0 - self.rho) * m * m / (new_accum + self.epsilon))
        state = torch.cat([new_accum, accum_update, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupAMSGrad(Rule):
    """GroupSparseApplyAMSGrad (training_ops.cc:1523). Slot layout
    m|v|vhat|linear."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, vhat, linear = _split(state, 4)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        new_vhat = torch.maximum(vhat, v / (1.0 - b2p))
        linear = (linear + m / (1.0 - b1p)
                  - (torch.sqrt(new_vhat) - torch.sqrt(vhat)) / lr * var)
        y = (torch.sqrt(new_vhat) + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, v, new_vhat, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupAdaBelief(Rule):
    """GroupSparseApplyAdaBelief (training_ops.cc:2982). Slot layout
    m|v|accum|linear; v tracks the (g-m)² belief."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, accum, linear = _split(state, 4)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * (grad - m) ** 2
        new_accum = v / (1.0 - b2p)
        linear = (linear + m / (1.0 - b1p)
                  - (torch.sqrt(new_accum) - torch.sqrt(accum)) / lr * var)
        y = (torch.sqrt(new_accum) + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, v, new_accum, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupAdaHessian(Rule):
    """GroupSparseApplyAdaHessian (training_ops.cc:2529). Slot layout
    m|v|accum|linear; ``extra`` is the per-row diagonal Hessian estimate."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True
    needs_extra = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        hessian = grad if extra is None else extra
        m, v, accum, linear = _split(state, 4)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * hessian * hessian
        new_accum = v / (1.0 - b2p)
        linear = (linear + m / (1.0 - b1p)
                  - (torch.sqrt(new_accum) - torch.sqrt(accum)) / lr * var)
        y = (torch.sqrt(new_accum) + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, v, new_accum, linear], dim=-1)
        return new_var, state, black


def _trust_ratio(r: Arr, var: Arr) -> Arr:
    r_norm = _norm(r)
    var_norm = _norm(var)
    return torch.where((r_norm > 0) & (var_norm > 0),
                       var_norm / (r_norm + 1e-8), torch.ones_like(r_norm))


@dataclasses.dataclass(frozen=True)
class GroupLamb(Rule):
    """GroupSparseApplyLamb (training_ops.cc:3400). Slot layout
    m|v|accum|linear; the trust ratio ‖var‖/‖r‖ scales the momentum term."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, accum, linear = _split(state, 4)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        new_m = m / (1.0 - b1p)
        new_accum = v / (1.0 - b2p)
        ratio = _trust_ratio(new_m / (torch.sqrt(new_accum) + self.epsilon),
                             var)
        linear = (linear + new_m * ratio[:, None]
                  - (torch.sqrt(new_accum) - torch.sqrt(accum)) / lr * var)
        y = (torch.sqrt(new_accum) + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, v, new_accum, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupLambHessian(Rule):
    """GroupSparseApplyLambHessian (training_ops.cc:3866): LAMB's group
    update with the Hessian estimate (``extra``) in the second moment.
    Slot layout m|v|accum|linear; l1/l2/l21 are not lr-scaled."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 4
    has_blacklist = True
    needs_extra = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        hessian = grad if extra is None else extra
        m, v, accum, linear = _split(state, 4)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * hessian * hessian
        new_m = m / (1.0 - b1p)
        new_accum = v / (1.0 - b2p)
        ratio = _trust_ratio(new_m / (torch.sqrt(new_accum) + self.epsilon),
                             var)
        linear = (linear + new_m * ratio[:, None]
                  - (torch.sqrt(new_accum) - torch.sqrt(accum)) / lr * var)
        y = (torch.sqrt(new_accum) + self.epsilon) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m, v, new_accum, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class LambHessian(Rule):
    """Dense ApplyLambHessian functor (training_ops.cc:4186-4218): direct
    trust-ratio update, no group lasso. Slot layout m|v."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6
    slot_width = 2
    needs_extra = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        hessian = grad if extra is None else extra
        m, v = _split(state, 2)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        adjust = torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        m = m + (grad - m) * (1.0 - self.beta1)
        v = v + (hessian * hessian - v) * (1.0 - self.beta2)
        denom = torch.sqrt(v) + self.epsilon
        ratio = _trust_ratio(m * adjust / denom, var)
        var = var - m * lr * adjust * ratio[:, None] / denom
        return var, torch.cat([m, v], dim=-1), None


@dataclasses.dataclass(frozen=True)
class AdaDQH(Rule):
    """AdaDQH, non-group form (training_ops.cc:4348-4374). Slot layout m|v;
    the second moment tracks h = m_new/(1-b1p) - m_old/β."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-5
    slot_width = 2

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v = _split(state, 2)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        beta = torch.where(_first(step, var), torch.ones_like(b1p),
                           1.0 - b1p / self.beta1)
        m_old = m / beta
        m_new = self.beta1 * m + (1.0 - self.beta1) * grad
        h = m_new / (1.0 - b1p) - m_old
        v = self.beta2 * v + (1.0 - self.beta2) * h * h
        denom = torch.maximum(torch.sqrt(v),
                              self.epsilon * torch.sqrt(1.0 - b2p))
        var = var - m_new * alpha / denom
        return var, torch.cat([m_new, v], dim=-1), None


@dataclasses.dataclass(frozen=True)
class GroupAdaDQH(Rule):
    """GroupSparseApplyAdaDQH V2 (training_ops.cc:5139): linear accumulator
    in lr-pre-scaled units, l1/l2/l21 times lr, and the old accumulator's
    epsilon floor from the previous step's ``ε·√(1−β2^(t−1))``. Slot layout
    m|v|linear."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-5
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 3
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, linear = _split(state, 3)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        eps_adj = self.epsilon * torch.sqrt(1.0 - b2p)
        # ε·√(1 − β2^(t−1)): zero at t=1 (β2^0 = 1)
        last_eps_adj = self.epsilon * torch.sqrt(
            torch.clamp(1.0 - b2p / self.beta2, min=0.0))
        beta = torch.where(_first(step, var), torch.ones_like(b1p),
                           1.0 - b1p / self.beta1)
        m_old = m / beta
        m_new = self.beta1 * m + (1.0 - self.beta1) * grad
        h = m_new / (1.0 - b1p) - m_old
        v_new = self.beta2 * v + (1.0 - self.beta2) * h * h
        accum_new = torch.maximum(torch.sqrt(v_new), eps_adj)
        accum_old = torch.maximum(torch.sqrt(v), last_eps_adj)
        linear = linear + m_new * alpha - (accum_new - accum_old) * var
        new_var, black = _group_lasso_solve(linear, accum_new, self.l1 * lr,
                                            self.l2 * lr, self.l21 * lr,
                                            var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m_new, v_new, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class GroupAdaDQHV1(Rule):
    """GroupSparseApplyAdaDQH version 1 (training_ops.cc:4854-5138): linear
    accumulator in unscaled units, raw l1/l2/l21, and the old accumulator's
    floor ``gamma`` from the current step's ε·√(1−β2^t) (0 at step 1). Slot
    layout m|v|linear."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-5
    l1: float = 0.0
    l2: float = 0.0
    l21: float = 0.0
    norm_axis: Optional[dist.ProcessGroup] = None
    slot_width = 3
    has_blacklist = True

    def update(self, var, state, grad, *, lr, step, extra=None):
        m, v, linear = _split(state, 3)
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        alpha = torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        eps_adj = self.epsilon * torch.sqrt(1.0 - b2p)
        first = _first(step, var)
        beta = torch.where(first, torch.ones_like(b1p),
                           1.0 - b1p / self.beta1)
        gamma = torch.where(first, torch.zeros_like(eps_adj), eps_adj)
        m_old = m / beta
        m_new = self.beta1 * m + (1.0 - self.beta1) * grad
        h = m_new / (1.0 - b1p) - m_old
        v_new = self.beta2 * v + (1.0 - self.beta2) * h * h
        linear = (linear + m_new * alpha
                  - (torch.maximum(torch.sqrt(v_new), eps_adj)
                     - torch.maximum(torch.sqrt(v), gamma)) / lr * var)
        y = torch.maximum(torch.sqrt(v_new), eps_adj) / lr
        new_var, black = _group_lasso_solve(linear, y, self.l1, self.l2,
                                            self.l21, var.shape[-1],
                                            norm_axis=self.norm_axis)
        state = torch.cat([m_new, v_new, linear], dim=-1)
        return new_var, state, black


@dataclasses.dataclass(frozen=True)
class RAdam(Rule):
    """Rectified Adam (rectified_adam.py:195-262): variance rectification
    with an SMA threshold, optional amsgrad, warmup and weight decay. Slot
    layout m|v (|vhat with amsgrad)."""
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-7
    weight_decay: float = 0.0
    amsgrad: bool = False
    sma_threshold: float = 5.0
    total_steps: int = 0
    warmup_proportion: float = 0.1
    min_lr: float = 0.0

    @property
    def slot_width(self):
        return 3 if self.amsgrad else 2

    def update(self, var, state, grad, *, lr, step, extra=None):
        t = _step(step, var).to(var.dtype)
        if self.total_steps > 0:
            warmup_steps = self.total_steps * self.warmup_proportion
            decay_steps = max(self.total_steps - warmup_steps, 1.0)
            decay_rate = (self.min_lr - lr) / decay_steps
            lr = torch.where(t <= warmup_steps,
                             lr * (t / warmup_steps),
                             lr + decay_rate * torch.clamp(
                                 t - warmup_steps, max=decay_steps))
        b1p, b2p = _powers(self.beta1, self.beta2, step, var)
        if self.amsgrad:
            m, v, vhat = _split(state, 3)
        else:
            m, v = _split(state, 2)
            vhat = None
        m = self.beta1 * m + (1.0 - self.beta1) * grad
        v = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        sma_inf = 2.0 / (1.0 - self.beta2) - 1.0
        sma_t = sma_inf - 2.0 * t * b2p / (1.0 - b2p)
        m_corr = m / (1.0 - b1p)
        if self.amsgrad:
            vhat = torch.maximum(vhat, v)
            v_corr = torch.sqrt(vhat / (1.0 - b2p))
        else:
            v_corr = torch.sqrt(v / (1.0 - b2p))
        r_t = torch.sqrt((sma_t - 4.0) / (sma_inf - 4.0)
                         * (sma_t - 2.0) / (sma_inf - 2.0)
                         * sma_inf / torch.clamp(sma_t, min=_TINY))
        var_t = torch.where(sma_t >= self.sma_threshold,
                            r_t * m_corr / (v_corr + self.epsilon), m_corr)
        if self.weight_decay:
            var_t = var_t + self.weight_decay * var
        var = var - lr * var_t
        parts = [m, v] + ([vhat] if self.amsgrad else [])
        return var, torch.cat(parts, dim=-1), None


# ---------------------------------------------------------------------------
# AdaDQH hypergradient computes — read-only functions over optimizer state
# (reference ComputeAdaDQHHG functor training_ops.cc:6556-6588;
# KvVariableComputeGroupAdaDQHHP :6317-6553).
# ---------------------------------------------------------------------------

def _prev_powers(beta1, beta2, step, like: Arr):
    """β^(step−1): the kernels bias-correct with the PREVIOUS step's
    powers; ``step`` is the upcoming 1-indexed step."""
    t = _step(step, like).to(like.dtype) - 1.0
    return _const_base_pow(beta1, t), _const_base_pow(beta2, t)


def adadqh_hg(m: Arr, v: Arr, *, lr, step, beta1=0.9, beta2=0.999,
              epsilon=1e-5, sam: bool = False, delta: Optional[Arr] = None,
              alpha=1.0) -> Tuple[Arr, Arr]:
    """ComputeAdaDQHHG: hypergradients of ``(lr, epsilon)`` from AdaDQH's
    first/second-moment state; ``sam`` adds ``−(1−α)·delta`` to the lr
    hypergradient."""
    b1p, b2p = _prev_powers(beta1, beta2, step, m)
    adjust = torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    eps_adj = epsilon * torch.sqrt(1.0 - b2p)
    sq = torch.sqrt(v)
    deno = torch.maximum(sq, eps_adj)
    ind = (eps_adj >= sq).to(m.dtype)
    lr_hg = -adjust * m / deno
    eps_hg = lr * adjust * m / (deno * deno) * ind
    if sam and delta is not None:
        lr_hg = lr_hg - (1.0 - alpha) * delta
    return lr_hg, eps_hg


def group_adadqh_hp(linear: Arr, v: Arr, *, lr, step, beta2=0.999,
                    epsilon=1e-5, l1=0.0, l2=0.0, l21=0.0,
                    dim: Optional[int] = None) -> Tuple[Arr, Arr]:
    """KvVariableComputeGroupAdaDQHHP: hypergradients of ``(lr, epsilon)``
    through the group-lasso solve; rows whose soft-thresholded group norm
    falls below ``l21·√dim`` get zeros."""
    d = linear.shape[-1] if dim is None else dim
    _, b2p = _prev_powers(beta2, beta2, step, linear)
    root = torch.sqrt(1.0 - b2p)
    eps_adj = epsilon * root
    adj = torch.clamp(linear, -l1, l1)
    l1_linear = adj - linear
    nrm = _norm(l1_linear)
    l21n = l21 * torch.sqrt(_f32(float(d), linear))
    keep = (nrm > l21n)[:, None]
    scale = (1.0 - l21n / torch.clamp(nrm, min=_TINY))[:, None]
    sq = torch.sqrt(v)
    y = torch.maximum(sq, eps_adj)
    deno = (y + 2.0 * l2 * lr) ** 2
    ind = (eps_adj >= sq).to(linear.dtype)
    lr_hg = torch.where(keep, y / deno * scale * l1_linear,
                        torch.zeros_like(linear))
    eps_hg = torch.where(keep, -lr * root / y * ind * scale * l1_linear,
                         torch.zeros_like(linear))
    return lr_hg, eps_hg


def Momentum(momentum=0.9, use_nesterov=False):
    """Plain momentum = GroupMomentum with zero regularisation."""
    return GroupMomentum(momentum=momentum, use_nesterov=use_nesterov)


def Adadelta(rho=0.95, epsilon=1e-8):
    return GroupAdadelta(rho=rho, epsilon=epsilon)


ALL_RULES = {
    "sgd": Sgd,
    "adagrad": Adagrad,
    "adam": Adam,
    "group_adam": GroupAdam,
    "group_adam_v1": GroupAdamV1,
    "group_ftrl": GroupFtrl,
    "ftrl": GroupFtrl,
    "group_momentum": GroupMomentum,
    "group_adadelta": GroupAdadelta,
    "group_amsgrad": GroupAMSGrad,
    "group_adabelief": GroupAdaBelief,
    "group_adahessian": GroupAdaHessian,
    "group_lamb": GroupLamb,
    "group_lamb_hessian": GroupLambHessian,
    "lamb_hessian": LambHessian,
    "adadqh": AdaDQH,
    "group_adadqh": GroupAdaDQH,
    "radam": RAdam,
}
