"""`lookup_syncs_per_request.serve`: the program's synchronize calls that start
inside the lookup layer's spans, per request (see `benchlib.spans`)."""
from benchlib import spans


def read(view):
    return spans.syncs(view, "serve", "lookup")
