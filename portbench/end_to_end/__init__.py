"""End-to-end metrics, one file each, named as in ``BENCHMARK.json``:
``read(record) -> float``, from the harness's host clock."""
