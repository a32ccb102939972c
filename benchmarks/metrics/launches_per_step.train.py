"""`launches_per_step.train`: CUDA kernels per training step."""
from benchlib import layers


def read(view):
    return layers.launches(view, "train")
