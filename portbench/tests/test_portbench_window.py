"""The window's bookkeeping with a host step: every block handed over is
counted and has one latency; the sample of kept blocks is drawn from the
seed."""

import time

import torch

from portbench.core import window


def test_every_block_has_a_latency():
    def step(state, x):
        return x + 1, state + 1

    blocks = torch.zeros((3, 2, 4))
    win = window.run(step, 0, blocks, 5, 0.05, window.Device(torch.device("cpu")), None)
    assert win.blocks > 10 and len(win.latencies) == win.blocks
    assert win.state == win.blocks and win.host_steps == win.blocks
    assert win.seconds >= 0.05 and all(lat >= 0 for lat in win.latencies)


def test_kept_blocks_are_a_seeded_sample():
    def picks(seed):
        k = window.Keeper(3, seed)
        for i in range(1000):
            k.offer(i, None, None, None)
        return sorted(item.index for item in k.kept)

    a = picks(2**31 + 1)
    assert a == picks(2**31 + 1) and a != picks(2**31 + 2)
    assert len(set(a)) == 3 and all(0 <= i < 1000 for i in a)
    late = [max(picks(s)) for s in range(50)]
    assert sum(i >= 500 for i in late) > 25  # the whole window is drawn from, not its start


def test_latency_runs_to_the_wait_two_blocks_later():
    def step(state, x):
        time.sleep(0.002)
        return x, state

    win = window.run(step, None, torch.zeros((1, 1)), 0, 0.05, window.Device(torch.device("cpu")),
                     None)
    # a block is seen complete before the block two after it is handed over
    assert min(win.latencies[:-2]) >= 0.004
