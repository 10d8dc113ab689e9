"""Real-to-real transforms: DCT-I..IV and DST-I..IV.

Port of :mod:`yagi_tpu.fft.r2r` (behavioral spec: liquid-dsp / FFTW's eight
REDFT/RODFT kinds with FFTW's unnormalized conventions, forward·inverse =
the logical-size scale). Each kind is one basis product ``y = x @ Bᵀ`` in
float32, batched over leading dims, exact for any N (the odd and prime sizes
liquid's autotests use). The basis is built in float64 on the host once per
(kind, N).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..errors import ConfigError
from ._input import as_signal

__all__ = ["dct", "dst", "r2r_inverse_scale"]


@lru_cache(maxsize=64)
def _dct_basis(kind: int, n: int) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)[None, :]
    k = np.arange(n, dtype=np.float64)[:, None]
    if kind == 1:  # REDFT00, N >= 2
        if n < 2:
            raise ConfigError(f"DCT-I size ({n}) must be >= 2")
        B = 2.0 * np.cos(np.pi * j * k / (n - 1))
        B[:, 0] = 1.0
        B[:, -1] = (-1.0) ** np.arange(n)
        return B
    if kind == 2:  # REDFT10
        return 2.0 * np.cos(np.pi * (j + 0.5) * k / n)
    if kind == 3:  # REDFT01
        B = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
        B[:, 0] = 1.0
        return B
    if kind == 4:  # REDFT11
        return 2.0 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)
    raise ConfigError(f"DCT kind ({kind}) must be in 1..4")


@lru_cache(maxsize=64)
def _dst_basis(kind: int, n: int) -> np.ndarray:
    j = np.arange(n, dtype=np.float64)[None, :]
    k = np.arange(n, dtype=np.float64)[:, None]
    if kind == 1:  # RODFT00
        return 2.0 * np.sin(np.pi * (j + 1.0) * (k + 1.0) / (n + 1))
    if kind == 2:  # RODFT10
        return 2.0 * np.sin(np.pi * (j + 0.5) * (k + 1.0) / n)
    if kind == 3:  # RODFT01
        B = 2.0 * np.sin(np.pi * (j + 1.0) * (k + 0.5) / n)
        B[:, -1] = (-1.0) ** np.arange(n)
        return B
    if kind == 4:  # RODFT11
        return 2.0 * np.sin(np.pi * (j + 0.5) * (k + 0.5) / n)
    raise ConfigError(f"DST kind ({kind}) must be in 1..4")


def _apply(basis: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    b = torch.from_numpy(basis.astype(np.float32)).to(x.device)
    return x.to(torch.float32) @ b.T


def dct(x, kind: int = 2, device=None) -> torch.Tensor:
    """DCT of ``x`` along the last axis (FFTW REDFT conventions)."""
    x = as_signal(x, device)
    return _apply(_dct_basis(kind, x.shape[-1]), x)


def dst(x, kind: int = 1, device=None) -> torch.Tensor:
    """DST of ``x`` along the last axis (FFTW RODFT conventions)."""
    x = as_signal(x, device)
    return _apply(_dst_basis(kind, x.shape[-1]), x)


def r2r_inverse_scale(kind: str, n: int) -> float:
    """FFTW logical-size normalization: applying the forward/inverse pair
    multiplies the data by this factor."""
    return {
        "dct1": 2.0 * (n - 1), "dct2": 2.0 * n, "dct3": 2.0 * n, "dct4": 2.0 * n,
        "dst1": 2.0 * (n + 1), "dst2": 2.0 * n, "dst3": 2.0 * n, "dst4": 2.0 * n,
    }[kind]
