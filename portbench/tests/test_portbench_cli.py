"""The command line: no card or no program, no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.core import registry


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "rxchain16.blk1m",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _no_result(_run(registry.ROOT))


def test_with_only_the_benchmark_there_is_no_result(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(registry.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert _no_result(proc)
    assert json.loads((tmp_path / "BENCHMARK.json").read_text()) == registry.benchmark()
