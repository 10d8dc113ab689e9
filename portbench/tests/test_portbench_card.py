"""On the card: each cell at a tiny size through the real kernels proves
correct, its control does not, and a traced run reads every per-layer metric
within its range. Run on a GPU: ``python -m pytest portbench/tests -q -m card``."""

import pytest

from portbench.core import registry
from portbench.tests.helpers import TINY, tiny_run

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_is_correct_on_the_card(cell, cuda_device):
    res = tiny_run(cell, device=cuda_device)
    assert res.correct, res.checks


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct_on_the_card(cell, cuda_device):
    assert not tiny_run(cell, device=cuda_device, control=True).correct


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run_reads_its_layers(cell, cuda_device):
    res = tiny_run(cell, device=cuda_device, trace=True, seconds=1.0)
    want = {m["name"] for m in registry.metrics_of(registry.benchmark(), cell, True)}
    assert set(res.line["metrics"]) == want
    for name, m in res.line["metrics"].items():
        if name.endswith("roofline_pct"):
            assert 0 < m["value"] <= 105
    assert res.line["device"]["busy_s"] > 0
    assert len(res.line["breakdown"]["device_ops"]) <= 10
