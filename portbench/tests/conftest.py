"""Tests of the benchmark. Those marked ``card`` need a CUDA device; they
decide so in the ``cuda_device`` fixture, never at import."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", 0)
