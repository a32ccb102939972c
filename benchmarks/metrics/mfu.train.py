"""`mfu.train`: see `benchlib.layers.mfu`."""
from benchlib import layers


def read(view):
    return layers.mfu(view, "train")
