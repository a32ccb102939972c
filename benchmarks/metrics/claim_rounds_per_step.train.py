"""`claim_rounds_per_step.train`: the insert's claim rounds
(`tfp::claim_round` spans) per training step."""
from benchlib import spans


def read(view):
    return spans.claim_rounds(view, "train")
