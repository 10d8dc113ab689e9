"""Polyphase filter bank decomposition (host-side NumPy).

Copied from :func:`yagi_tpu.filter.firpfb.pfb_decompose` (firpfb.rs:42).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pfb_decompose"]


def pfb_decompose(h: np.ndarray, num_filters: int) -> np.ndarray:
    """[M·Lsub] prototype → [M, Lsub] branch matrix, convolution order.

    branches[i, j] = h[i + j·M]; truncates any trailing remainder exactly as
    the reference's h_sub_len = h_len // num_filters (firpfb.rs:42).
    """
    h = np.asarray(h)
    sub_len = len(h) // num_filters
    return np.stack(
        [h[i : i + sub_len * num_filters : num_filters] for i in range(num_filters)]
    )
