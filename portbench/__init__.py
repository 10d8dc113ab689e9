"""The benchmark of ``yagi_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Each
configuration, traffic mix, signal, reference, work count and metric is a
file of its own under this directory, found by the name that
``BENCHMARK.json`` or a workload file gives it (:mod:`portbench.core.registry`).
"""
