"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import claim, compactor, flash_attention, probe, rowops
from .compactor import compact
from .flash_attention import flash_attention as fmha, reference_attention
from .flash_attention import (flash_bwd_dkv, flash_bwd_dq, flash_bwd_single,
                              flash_fwd, flash_fwd_single)
from .rowops import gather_rows, scatter_rows
