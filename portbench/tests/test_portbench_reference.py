"""The plain references against the port's CPU route (its kernels' plain
versions) at tiny sizes, through the whole run: set-up, window, check."""

import numpy as np
import pytest
import torch

from portbench.reference import fused_rx_chain as chain_ref
from portbench.tests.helpers import TINY, tiny_run
from yagi_tpu_torch.chains import FusedRxChain


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_agrees_with_the_port_on_cpu(cell):
    res = tiny_run(cell)
    assert res.correct, res.checks
    assert res.line["attempted"] > 0 and res.line["failed"] == 0
    assert list(res.line)[-1] == "checks"


def test_qam_reference_equals_the_plain_loops_bit_for_bit():
    res = tiny_run("qamrx2048.blk4k")
    assert res.checks["soft_gap"][0] == 0.0
    assert res.checks["state_gap"][0] == 0.0


def test_chain_reference_two_stages_equal_the_ports_combined_filters():
    cfg = {"channels": 3, "n_taps": 64, "fc": 0.2, "as": 60.0, "rate": 2.0, "m": 7,
           "npfb": 256, "mix_freq": 0.35}
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn((3, 384), dtype=torch.complex64, generator=gen) for _ in range(3)]
    rx = FusedRxChain.create(n_taps=64, fc=0.2, as_=60.0, rate=2.0, mix_freq=0.35,
                             batch_shape=(3,), device="cpu")
    des = chain_ref.design(cfg)
    assert des["d_theta"] == int(rx.d_theta)
    hist = torch.zeros((3, chain_ref.HIST), dtype=torch.complex64)
    theta = 0
    for x in xs:
        y, _, rx = rx.step(x)
        want = chain_ref.chain(x, hist, theta, des)
        gap = (y.to(want.dtype) - want).abs().max() / want.abs().square().mean().sqrt()
        assert gap < 1e-5
        hist, theta = x[:, -chain_ref.HIST:], (theta + 384 * 2 * des["d_theta"]) & chain_ref.U32
        assert int(rx.theta) == theta


def test_phase_step_follows_liquids_float32_rule():
    # 0.35 rad/sample: float32(0.35) / float32(2π) · 2^32, truncated
    want = int(np.float32(np.float32(0.35) / np.float32(2 * np.pi)) * np.float32(2.0**32))
    assert chain_ref.phase_step(0.35) == want
    assert chain_ref.phase_step(-0.35) == int(
        np.float32(np.float32(np.float32(-0.35) + np.float32(2 * np.pi)) / np.float32(2 * np.pi))
        * np.float32(2.0**32))
