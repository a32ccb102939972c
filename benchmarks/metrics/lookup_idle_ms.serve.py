"""`lookup_idle_ms.serve`: device-idle time inside the lookup layer's
spans per request, in ms (see `benchlib.spans`)."""
from benchlib import spans


def read(view):
    return spans.idle_ms(view, "serve", "lookup")
