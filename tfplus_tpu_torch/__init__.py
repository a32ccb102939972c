"""tfplus_tpu_torch — the PyTorch and CUDA port of tfplus_tpu.

Same module layout and public names as the JAX package, which stays the
reference the port is held against. Plain tensor code is PyTorch; the TPU
kernels become hand-written Hopper kernels (``ops/csrc``), built with nvcc at
first use. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``. This package imports neither JAX nor ``tfplus_tpu``.
"""
from . import (checkpoint, convert, embedding, io, kv, models, nn, ops, optim,
               train, utils)
from .version import __version__
