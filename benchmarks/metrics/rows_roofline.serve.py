"""`rows_roofline.serve`: see `benchlib.layers.rows_roofline`."""
from benchlib import layers


def read(view):
    return layers.rows_roofline(view, "serve")
