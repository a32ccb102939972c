"""`sparse_opt_idle_ms.train`: device-idle time inside the sparse_opt layer's
spans per step, in ms (see `benchlib.spans`)."""
from benchlib import spans


def read(view):
    return spans.idle_ms(view, "train", "sparse_opt")
