"""Per-layer metrics, one file each, named as in ``BENCHMARK.json``:
``read(record) -> float | None`` from the traced run (the window's host
clock, the profiled slice's device operations and the harness's spans).
A reader that finds nothing to read returns None and the metric is left out
of the result line."""
