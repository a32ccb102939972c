"""`flash_roofline.train`: see `benchlib.layers.flash_roofline`."""
from benchlib import layers


def read(view):
    return layers.flash_roofline(view, "train")
