"""`feed_idle_ms.train`: device-idle time inside the feed layer's
spans per step, in ms (see `benchlib.spans`)."""
from benchlib import spans


def read(view):
    return spans.idle_ms(view, "train", "feed")
