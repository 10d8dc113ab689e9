"""The harness's general parts: finding files by name, the timed window,
the reading of the profiler's trace, statistics and the result line."""
