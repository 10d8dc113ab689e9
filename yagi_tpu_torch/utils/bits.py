"""Bit manipulation utilities (host-side Python ints and NumPy).

Copied from :mod:`yagi_tpu.utils.bits` (the reference's utility/bits.rs:41-110).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "count_ones",
    "count_ones_mod2",
    "bdotprod",
    "count_bit_errors",
    "count_bit_errors_array",
    "byte_reverse",
    "halfword_reverse",
    "word_reverse",
    "count_leading_zeros",
    "msb_index",
]


def count_ones(x: int) -> int:
    """Hamming weight (bits.rs:41)."""
    return bin(x & 0xFFFFFFFF).count("1")


def count_ones_mod2(x: int) -> int:
    """Parity (bits.rs)."""
    return count_ones(x) & 1


def bdotprod(x: int, y: int) -> int:
    """Binary dot product = parity(x & y) (bits.rs)."""
    return count_ones_mod2(x & y)


def count_bit_errors(a: int, b: int) -> int:
    """Hamming distance (bits.rs)."""
    return count_ones(a ^ b)


def count_bit_errors_array(a, b) -> int:
    """Total bit errors between byte arrays (bits.rs)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return int(np.sum(np.bitwise_count(a ^ b)))


def byte_reverse(x: int) -> int:
    """Reverse bits within one byte (bits.rs)."""
    x &= 0xFF
    x = ((x & 0xF0) >> 4) | ((x & 0x0F) << 4)
    x = ((x & 0xCC) >> 2) | ((x & 0x33) << 2)
    x = ((x & 0xAA) >> 1) | ((x & 0x55) << 1)
    return x


def halfword_reverse(x: int) -> int:
    """Reverse bits within a 16-bit halfword (bits.rs, reverse_uint16)."""
    out = 0
    for i in range(16):
        out = (out << 1) | ((x >> i) & 1)
    return out


def word_reverse(x: int) -> int:
    """Reverse bits within a 32-bit word (bits.rs)."""
    out = 0
    for i in range(32):
        out = (out << 1) | ((x >> i) & 1)
    return out


def count_leading_zeros(x: int) -> int:
    """Leading zeros in a 32-bit word (bits.rs)."""
    if x == 0:
        return 32
    return 32 - (x & 0xFFFFFFFF).bit_length()


def msb_index(x: int) -> int:
    """1-based index of the most significant set bit; 0 for x=0 (bits.rs)."""
    return (x & 0xFFFFFFFF).bit_length()
