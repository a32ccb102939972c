"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import rowops
from .rowops import gather_rows, scatter_rows
