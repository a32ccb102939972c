"""Sparse optimizers over KV tables and their dense twins."""
from . import dense, rules
from .base import SparseOptimizer
from .rules import (Rule, Sgd, Adagrad, Adam, GroupAdam, GroupFtrl,
                    GroupMomentum, GroupAdadelta, GroupAMSGrad,
                    GroupAdaBelief, GroupAdaHessian, GroupLamb, AdaDQH,
                    GroupAdaDQH, RAdam, Momentum, Adadelta, ALL_RULES)
