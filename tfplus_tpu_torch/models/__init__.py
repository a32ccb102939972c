"""Sparse models on KV tables: the serving and training steps."""
from . import bst, common, dcn, deepfm, din, dlrm, ncf
from .bst import BST
from .common import (SparseModel, TrainState, grow_if_needed, init_state,
                     make_train_step, make_train_step_scan)
from .dcn import DCN
from .deepfm import DeepFM, WideDeep
from .din import DIN
from .dlrm import DLRM
from .ncf import NCF
