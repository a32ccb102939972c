"""The benchmark's general parts: finding configurations, traffic mixes and
metrics by name, making inputs from the seed, the measured loops, the
profiler trace and its reduction, the comparison that decides ``correct``
and the result line. Only ``program`` imports the system under test."""
