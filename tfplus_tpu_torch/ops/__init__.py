"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import compactor, flash_attention, rowops
from .compactor import compact
from .flash_attention import (flash_bwd_dkv, flash_bwd_dq, flash_bwd_single,
                              flash_fwd, flash_fwd_single)
from .rowops import gather_rows, scatter_rows
