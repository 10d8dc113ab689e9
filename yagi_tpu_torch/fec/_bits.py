"""Byte<->bit packing helpers for the FEC layer (MSB-first, liquid order).

Copied from :mod:`yagi_tpu.fec._bits`. Packet-rate byte work: it runs on
the host in numpy, as in yagi_tpu.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unpack_bits", "pack_bits"]


def unpack_bits(data) -> np.ndarray:
    """Bytes [..., n] -> bits [..., 8n], MSB first."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data, axis=-1)


def pack_bits(bits) -> np.ndarray:
    """Bits [..., m] -> bytes [..., ceil(m/8)], MSB first, zero-padded."""
    bits = np.asarray(bits, dtype=np.uint8) & 1
    pad = (-bits.shape[-1]) % 8
    if pad:
        shape = list(bits.shape)
        shape[-1] = pad
        bits = np.concatenate([bits, np.zeros(shape, np.uint8)], axis=-1)
    return np.packbits(bits, axis=-1)
