"""`host_syncs_per_step.train`: the step's synchronize calls per step."""
from benchlib import layers


def read(view):
    return layers.host_syncs(view, "train")
