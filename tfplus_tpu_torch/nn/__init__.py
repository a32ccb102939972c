"""Dense layers for the model towers, and the flash-attention layer."""
from . import attention, layers
from .attention import flash_attention_layer
from .layers import CrossNet, Dense, MLP
