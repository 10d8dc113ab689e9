"""Tiny sizes of each cell, for runs on the CPU."""

import time

import torch

from portbench.core import registry, runner

# each cell at a size a test run holds: few channels, short blocks, a short cycle
TINY = {
    "rxchain16.blk1m": {"channels": 4, "block": 512, "cycle_blocks": 4},
    "qamrx2048.blk4k": {"channels": 4, "block": 64, "cycle_samples": 512, "start_samples": 64},
}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def tiny_run(cell: str, device=torch.device("cpu"), seconds: float = 0.3, resize=None,
             **kw) -> runner.Result:
    return runner.run_cell(registry.benchmark(), cell, SEED, seconds, kw.pop("trace", False),
                           device, time.time(), resize=TINY[cell] if resize is None else resize,
                           **kw)
