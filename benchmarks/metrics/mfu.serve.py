"""`mfu.serve`: see `benchlib.layers.mfu`."""
from benchlib import layers


def read(view):
    return layers.mfu(view, "serve")
