"""The general parts of the harness: the registry that finds a cell's
files by name, the request generator, the measured window, the spans
and the profiler reading."""
