"""Host-side helpers: meta-word packing and device resolution."""
from . import device, packing
