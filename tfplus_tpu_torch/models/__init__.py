"""Sparse models on KV tables (serving step ported; training later)."""
from . import bst, common, dcn, din
from .bst import BST
from .common import SparseModel, TrainState, init_state, make_train_step
from .dcn import DCN
from .din import DIN
