"""`launches_per_request.serve`: CUDA kernels per request."""
from benchlib import layers


def read(view):
    return layers.launches(view, "serve")
