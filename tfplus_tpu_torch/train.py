"""tfplus_tpu_torch.train — optimizer constructors mirroring the reference's
``tfplus.train`` namespace (tfplus/__init__.py:20-28; python/training/*.py).

Counterpart of ``tfplus_tpu/train.py``, with the same constructors and slot
names. Each returns a :class:`~tfplus_tpu_torch.optim.SparseOptimizer` whose
keyword arguments match the reference optimizer class of the same name, so a
TFPlus user can port ``tfplus.train.GroupAdamOptimizer(lr, ...)`` verbatim.
"""
from __future__ import annotations

from .optim import rules as _r
from .optim.base import SparseOptimizer


def GradientDescentOptimizer(learning_rate=0.01, **_):
    """gradient_descent.py:24-31 — scatter-sub of lr·g."""
    del learning_rate  # lr is passed at apply() time; kept for signature parity
    return SparseOptimizer(_r.Sgd(), slot_name="sgd")


def AdagradOptimizer(learning_rate=0.001, initial_accumulator_value=0.1, **_):
    """adagrad.py:26-44."""
    return SparseOptimizer(
        _r.Adagrad(initial_accumulator_value=initial_accumulator_value),
        slot_name="accum")


def AdamOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                  version=2, **_):
    """adam.py:36-171 (version 2 fused m_v slot is the only behaviour —
    version 1's split slots are an artifact of the PS layout)."""
    return SparseOptimizer(_r.Adam(beta1=beta1, beta2=beta2, epsilon=epsilon),
                           slot_name="m_v")


def GroupAdamOptimizer(learning_rate=0.001, initial_accumulator_value=0.0,
                       beta1=0.9, beta2=0.999, epsilon=1e-8,
                       l1_regularization_strength=0.0,
                       l2_regularization_strength=0.0,
                       l21_regularization_strength=0.0, version=4, **_):
    """group_adam.py:28-272. ``version`` routes like the reference:
    1 → the legacy bias-corrected-accumulator kernel (GroupSparseApplyAdam,
    training_ops.cc:1065 — genuinely different trajectory, own rule);
    2/3/4 → the m|v|linear form (V2/V3/V4 kernels are algebraically
    identical for a constant lr — V4 just pre-scales l1/l2/l21 by lr and
    drops the /lr from the linear accumulation; V2→V3 only re-packs the
    slots into one concat table)."""
    if version == 1:
        return SparseOptimizer(
            _r.GroupAdamV1(beta1=beta1, beta2=beta2, epsilon=epsilon,
                           l1=l1_regularization_strength,
                           l2=l2_regularization_strength,
                           l21=l21_regularization_strength,
                           initial_accumulator_value=
                           initial_accumulator_value),
            slot_name="m_v_accum_linear")
    return SparseOptimizer(
        _r.GroupAdam(beta1=beta1, beta2=beta2, epsilon=epsilon,
                     l1=l1_regularization_strength,
                     l2=l2_regularization_strength,
                     l21=l21_regularization_strength),
        slot_name="m_v_linear")


def SparseGroupFtrlOptimizer(learning_rate=0.1, learning_rate_power=-0.5,
                             initial_accumulator_value=0.1,
                             l1_regularization_strength=0.0,
                             l2_regularization_strength=0.0,
                             l21_regularization_strength=0.0,
                             l2_shrinkage_regularization_strength=0.0, **_):
    """sparse_group_ftrl.py:26-96 → KvVariableSparseGroupSparseApplyFtrlV2.
    With lr_power=-0.5 this is the reference README's 'GroupAdagrad'."""
    return SparseOptimizer(
        _r.GroupFtrl(lr_power=learning_rate_power,
                     initial_accumulator_value=initial_accumulator_value,
                     l1=l1_regularization_strength,
                     l2=l2_regularization_strength,
                     l21=l21_regularization_strength,
                     l2_shrinkage=l2_shrinkage_regularization_strength),
        slot_name="accum_linear")


# README's "GroupAdagrad" naming (example/dcn/README.md:79-84)
GroupAdagradOptimizer = SparseGroupFtrlOptimizer


def MomentumOptimizer(learning_rate=0.01, momentum=0.9, use_nesterov=False,
                      l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupMomentum(momentum=momentum, use_nesterov=use_nesterov,
                         l1=l1, l2=l2, l21=l21), slot_name="m_accum_linear")


def AdadeltaOptimizer(learning_rate=1.0, rho=0.95, epsilon=1e-8,
                      l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupAdadelta(rho=rho, epsilon=epsilon, l1=l1, l2=l2, l21=l21),
        slot_name="adadelta")


def AMSGradOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupAMSGrad(beta1=beta1, beta2=beta2, epsilon=epsilon,
                        l1=l1, l2=l2, l21=l21), slot_name="amsgrad")


def AdaBeliefOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupAdaBelief(beta1=beta1, beta2=beta2, epsilon=epsilon,
                          l1=l1, l2=l2, l21=l21), slot_name="adabelief")


def AdaHessianOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                        epsilon=1e-8, l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupAdaHessian(beta1=beta1, beta2=beta2, epsilon=epsilon,
                           l1=l1, l2=l2, l21=l21), slot_name="adahessian")


def LambOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6,
                  l1=0.0, l2=0.0, l21=0.0, **_):
    return SparseOptimizer(
        _r.GroupLamb(beta1=beta1, beta2=beta2, epsilon=epsilon,
                     l1=l1, l2=l2, l21=l21), slot_name="lamb")


def LambHessianOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                         epsilon=1e-6, l1=0.0, l2=0.0, l21=0.0, **_):
    """LAMB with Hutchinson diagonal-Hessian second moment — pass the
    per-row hessian estimate via ``opt.apply(..., extra=hessian)``
    (KvVariableGroupSparseApplyLambHessian, training_ops.cc:3866; dense
    twin rules.LambHessian / :4219)."""
    return SparseOptimizer(
        _r.GroupLambHessian(beta1=beta1, beta2=beta2, epsilon=epsilon,
                            l1=l1, l2=l2, l21=l21),
        slot_name="lamb_hessian")


def AdaDQHOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                    epsilon=1e-5, l1=0.0, l2=0.0, l21=0.0,
                    use_group=False, version=2, **_):
    """AdaDQH (training_ops.cc:4348+) — in-house quasi-hyperbolic Adam.

    ``version`` routes the group form like GroupAdamOptimizer's version
    param: 2 (default) → GroupSparseApplyAdaDQHV2 (training_ops.cc:5139),
    1 → the legacy GroupSparseApplyAdaDQH trajectory (:4854, unscaled
    linear + current-step epsilon floor). Non-group AdaDQH has one kernel
    in the reference; ``version`` is ignored without use_group/λ."""
    if use_group or l1 or l2 or l21:
        if version == 1:
            rule = _r.GroupAdaDQHV1(beta1=beta1, beta2=beta2,
                                    epsilon=epsilon, l1=l1, l2=l2, l21=l21)
        elif version == 2:
            rule = _r.GroupAdaDQH(beta1=beta1, beta2=beta2, epsilon=epsilon,
                                  l1=l1, l2=l2, l21=l21)
        else:
            raise ValueError(f"AdaDQH group version must be 1 or 2, "
                             f"got {version}")
    else:
        rule = _r.AdaDQH(beta1=beta1, beta2=beta2, epsilon=epsilon)
    return SparseOptimizer(rule, slot_name="adadqh")


def RectifiedAdamOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
                           epsilon=1e-7, weight_decay=0.0, amsgrad=False,
                           sma_threshold=5.0, total_steps=0,
                           warmup_proportion=0.1, min_lr=0.0, **_):
    """rectified_adam.py:26-377."""
    return SparseOptimizer(
        _r.RAdam(beta1=beta1, beta2=beta2, epsilon=epsilon,
                 weight_decay=weight_decay, amsgrad=amsgrad,
                 sma_threshold=sma_threshold, total_steps=total_steps,
                 warmup_proportion=warmup_proportion, min_lr=min_lr),
        slot_name="radam")
