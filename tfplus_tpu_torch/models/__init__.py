"""Sparse models on KV tables (serving step ported; training later)."""
from . import common, dcn
from .common import SparseModel, TrainState, init_state, make_train_step
from .dcn import DCN
