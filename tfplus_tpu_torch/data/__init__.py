"""Data readers and the packed batch feed (counterpart of
``tfplus_tpu/data``)."""
from . import criteo, feed, movielens, synthetic
from .feed import make_packed_feed
