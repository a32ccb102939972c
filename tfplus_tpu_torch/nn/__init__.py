"""Dense layers for the model towers."""
from . import layers
from .layers import CrossNet, Dense, MLP
