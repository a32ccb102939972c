"""Sparse models on KV tables: the serving and training steps."""
from . import bst, common, dcn, deepfm, din, dlrm, module_adapter, ncf
from .bst import BST
from .common import (SparseModel, TrainState, grow_if_needed, init_state,
                     init_state_multi, make_train_step, make_train_step_multi,
                     make_train_step_scan)
from .dcn import DCN
from .deepfm import DeepFM, WideDeep
from .din import DIN
from .dlrm import DLRM
from .module_adapter import ModuleSparseModel
from .ncf import NCF
