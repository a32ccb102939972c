"""`rows_roofline.train`: see `benchlib.layers.rows_roofline`."""
from benchlib import layers


def read(view):
    return layers.rows_roofline(view, "train")
