"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: ``BENCHMARK.json`` names the cell, the
files under ``portbench/`` define it, and ``yagi_tpu_torch`` is the program.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the port and this package by absolute name, nothing of portbench/ at top level
    from portbench.core.runner import main

    sys.exit(main(sys.argv[1:], ROOT))
