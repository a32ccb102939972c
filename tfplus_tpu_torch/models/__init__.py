"""Sparse models on KV tables: the serving and training steps."""
from . import bst, common, dcn, din
from .bst import BST
from .common import (SparseModel, TrainState, grow_if_needed, init_state,
                     make_train_step, make_train_step_scan)
from .dcn import DCN
from .din import DIN
