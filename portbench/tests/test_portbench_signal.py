"""The inputs: seeded, shaped as the cell says, and the 16-QAM cycle joins
without a seam."""

import math

import pytest
import torch

from portbench.core import registry
from portbench.reference import qam_rx as ref
from portbench.signals import normal, qam16_periodic as qam


def test_qam_cycle_joins_without_a_seam():
    c, n = 3, 256
    gen = torch.Generator().manual_seed(3)
    table = ref.constellation("qam16", "cpu")
    pulse = ref.rrcos(2, 7, 0.3)
    syms = torch.randint(0, 16, (c, n // 2), generator=gen)
    x = qam.periodic(syms, torch.zeros((c, n), dtype=torch.complex64), table, pulse)
    # the same symbols three times over, filtered and echoed as a line, the
    # carrier turning once a cycle: its middle and last cycles are the cycle
    up = torch.zeros((c, 3 * n), dtype=torch.complex128)
    up[:, ::2] = table[syms.repeat(1, 3)].to(torch.complex128)
    sig = torch.zeros_like(up)
    for j, hj in enumerate(pulse):
        sig[:, j:] += float(hj) * up[:, : 3 * n - j]
    s = sig.clone()
    s[:, qam.ECHO_DELAY:] += qam.ECHO * sig[:, : 3 * n - qam.ECHO_DELAY]
    t = torch.arange(3 * n, dtype=torch.float64)
    line = qam.GAIN * s * torch.polar(torch.ones_like(t), qam.PHASE + 2 * math.pi / n * t)
    for k in (1, 2):
        assert torch.allclose(line[:, k * n:(k + 1) * n].to(torch.complex64), x, atol=1e-6)


@pytest.mark.parametrize("cell", ["qamrx2048.blk4k", "rxchain16.blk1m"])
def test_inputs_are_seeded_and_shaped(cell):
    wl = registry.data("workloads", cell)
    cfg = registry.data("configs", wl["config"])
    cfg["channels"] = 2
    if "cycle_samples" in wl:
        wl["cycle_samples"], wl["block"] = 512, 128
    else:
        wl["cycle_blocks"], wl["block"] = 3, 64
    make = registry.module("signals", wl["signal"]).make
    a, b, other = (make(cfg, wl, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert a.dtype == torch.complex64 and a.shape[1:] == (2, wl["block"])
    n_blocks = wl["cycle_samples"] // wl["block"] if "cycle_samples" in wl else wl["cycle_blocks"]
    assert a.shape[0] == n_blocks
    assert a[0].is_contiguous()


def test_normal_noise_has_unit_parts():
    x = normal.make({"channels": 8}, {"cycle_blocks": 4, "block": 4096}, 11, "cpu")
    assert abs(x.real.var().item() - 1.0) < 0.02 and abs(x.imag.var().item() - 1.0) < 0.02
