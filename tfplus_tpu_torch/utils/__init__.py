"""Host-side helpers: meta-word packing, device resolution, progress."""
from . import device, packing, progress
