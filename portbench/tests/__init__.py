"""CPU tests of the benchmark's harness (``python -m pytest portbench/tests -q``);
tests marked ``card`` run on an NVIDIA GPU and skip elsewhere."""
