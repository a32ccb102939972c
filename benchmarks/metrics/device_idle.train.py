"""`device_idle.train`: see `benchlib.layers.device_idle`."""
from benchlib import layers


def read(view):
    return layers.device_idle(view, "train")
