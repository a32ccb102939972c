"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import flash_attention, rowops
from .flash_attention import (flash_bwd_dkv, flash_bwd_dq, flash_fwd,
                              flash_fwd_single)
from .rowops import gather_rows, scatter_rows
