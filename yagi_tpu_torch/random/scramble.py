"""Data scrambler (static 4-byte XOR mask), host-side NumPy.

Copied from :mod:`yagi_tpu.random.scramble` (the reference's
random/scramble.rs): masks {0xCA, 0xCC, 0x53, 0x5F} applied cyclically per
byte; unscramble is the same XOR; the soft variant flips 0..255 soft bits
where the mask bit is set (scramble.rs:37-53).
"""

from __future__ import annotations

import numpy as np

__all__ = ["scramble_data", "unscramble_data", "unscramble_data_soft"]

_MASKS = np.array([0xCA, 0xCC, 0x53, 0x5F], dtype=np.uint8)


def scramble_data(x) -> np.ndarray:
    """XOR bytes with the cyclic mask (scramble.rs:7)."""
    x = np.asarray(x, dtype=np.uint8).copy()
    mask = np.resize(_MASKS, len(x))
    return x ^ mask


def unscramble_data(x) -> np.ndarray:
    """Identical to scramble (XOR involution, scramble.rs:31)."""
    return scramble_data(x)


def unscramble_data_soft(x) -> np.ndarray:
    """Flip soft bytes (0..255) where the mask bit is set (scramble.rs:37).

    x holds 8 soft bits per original byte; group i of 8 uses mask i%4.
    """
    x = np.asarray(x, dtype=np.uint8).copy()
    n_groups = len(x) // 8
    for i in range(n_groups):
        mask = int(_MASKS[i % 4])
        for j in range(8):
            if (mask >> (7 - j)) & 1:
                x[8 * i + j] = 255 - x[8 * i + j]
    return x
