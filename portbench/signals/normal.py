"""Standard-normal complex noise, real and imaginary parts each N(0, 1)
(``yagi_tpu_torch/tools/paths.py::complex_block``'s distribution), drawn on
the device: ``cycle_blocks`` blocks of ``channels`` × ``block`` samples."""

from __future__ import annotations

import torch


def make(cfg: dict, wl: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (wl["cycle_blocks"], cfg["channels"], wl["block"], 2)
    return torch.view_as_complex(torch.randn(shape, generator=gen, device=device))
