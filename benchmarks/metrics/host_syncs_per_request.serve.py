"""`host_syncs_per_request.serve`: the request's synchronize calls per
request, the harness's copy of the predictions left out."""
from benchlib import layers


def read(view):
    return layers.host_syncs(view, "serve")
