"""`insert_syncs_per_step.train`: the program's synchronize calls that start
inside the insert layer's spans, per step (see `benchlib.spans`)."""
from benchlib import spans


def read(view):
    return spans.syncs(view, "train", "insert")
