"""Host-side helpers: meta-word packing, device resolution, progress,
profiling."""
from . import device, packing, profiling, progress
