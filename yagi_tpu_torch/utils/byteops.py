"""Byte/bit array manipulation and misc vector utilities.

Copied from :mod:`yagi_tpu.utils.byteops` (liquid-dsp's ``pack_bytes``,
``shift_array``, ``bshift_array``, ``unwrap_phase`` and ``sumsq`` helpers).
Behavior follows the liquid-dsp C conventions:

- ``pack_bytes(sym, k)``: pack one k-bit symbol per input element into a
  packed big-endian bitstream of bytes (MSB first).
- ``unpack_bytes(data, k)``: inverse — split a packed byte array into k-bit
  symbols, MSB first.
- ``repack_bytes(sym, k_in, k_out)``: convert an array of k_in-bit symbols
  into k_out-bit symbols through the packed bitstream.
- ``lshift``/``rshift``: byte-wise array shift, zero-filling.
- ``lcircshift``/``rcircshift``: byte-wise circular shift.
- ``lbshift``/``rbshift``: bit-wise array shift across byte boundaries.
- ``lbcircshift``/``rbcircshift``: bit-wise circular shift.
- ``unwrap_phase``: ±2π phase unwrap.
- ``sumsqf``/``sumsqcf``: sum of squares (liquid dotprod module helpers).

Where it runs: on the host in numpy, as in yagi_tpu (packet-rate byte work
of the bit-level framing layer).
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = [
    "pack_bytes",
    "unpack_bytes",
    "repack_bytes",
    "pack_array",
    "unpack_array",
    "lshift",
    "rshift",
    "lcircshift",
    "rcircshift",
    "lbshift",
    "rbshift",
    "lbcircshift",
    "rbcircshift",
    "unwrap_phase",
    "sumsqf",
    "sumsqcf",
]


def _to_bits(symbols: np.ndarray, k: int) -> np.ndarray:
    """Symbols [n] of k bits each → bit array [n*k], MSB first per symbol."""
    symbols = np.asarray(symbols, dtype=np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64)
    return ((symbols[:, None] >> shifts[None, :]) & 1).astype(np.uint8).reshape(-1)


def _from_bits(bits: np.ndarray, k: int) -> np.ndarray:
    """Bit array [n*k] → symbols [n], MSB first per symbol."""
    bits = np.asarray(bits, dtype=np.uint64).reshape(-1, k)
    weights = (np.uint64(1) << np.arange(k - 1, -1, -1, dtype=np.uint64))
    out = (bits * weights).sum(axis=1)
    if k <= 8:
        return out.astype(np.uint8)
    if k <= 16:
        return out.astype(np.uint16)
    return out.astype(np.uint32)


def pack_bytes(symbols, k: int = 1) -> np.ndarray:
    """Pack k-bit symbols into a big-endian byte stream (liquid pack_bytes).

    The total bit count n*k is zero-padded up to a whole number of bytes.
    """
    if not 1 <= k <= 32:
        raise ConfigError(f"symbol size {k} out of range [1,32]")
    bits = _to_bits(np.asarray(symbols).reshape(-1), k)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    return _from_bits(bits, 8)


def unpack_bytes(data, k: int = 1, n: int | None = None) -> np.ndarray:
    """Unpack a byte stream into k-bit symbols, MSB first (liquid unpack_bytes).

    ``n`` caps the number of output symbols (default: as many whole symbols
    as the stream holds).
    """
    if not 1 <= k <= 32:
        raise ConfigError(f"symbol size {k} out of range [1,32]")
    bits = _to_bits(np.asarray(data, dtype=np.uint8).reshape(-1), 8)
    n_max = len(bits) // k
    n = n_max if n is None else int(n)
    if n > n_max:
        raise ConfigError(f"requested {n} symbols but stream holds only {n_max}")
    return _from_bits(bits[: n * k], k)


def repack_bytes(symbols, k_in: int, k_out: int, n_out: int | None = None) -> np.ndarray:
    """Convert k_in-bit symbols to k_out-bit symbols (liquid repack_bytes).

    Bits flow MSB-first through a conceptual bitstream; trailing bits are
    zero-padded to fill the final output symbol (liquid's convention).
    """
    if not 1 <= k_in <= 32 or not 1 <= k_out <= 32:
        raise ConfigError("symbol sizes must be in [1,32]")
    bits = _to_bits(np.asarray(symbols).reshape(-1), k_in)
    n_max = -(-len(bits) // k_out)  # ceil
    n_out = n_max if n_out is None else int(n_out)
    need = n_out * k_out
    if need > len(bits):
        bits = np.concatenate([bits, np.zeros(need - len(bits), dtype=np.uint8)])
    return _from_bits(bits[:need], k_out)


def pack_array(dest: np.ndarray, bit_index: int, bits_per_symbol: int, sym: int) -> np.ndarray:
    """Insert one symbol into a packed byte array at a bit offset
    (liquid liquid_pack_array). Returns the modified copy."""
    dest = np.array(dest, dtype=np.uint8, copy=True)
    total_bits = dest.size * 8
    if bit_index + bits_per_symbol > total_bits:
        raise ConfigError("symbol overruns array")
    for i in range(bits_per_symbol):
        bit = (int(sym) >> (bits_per_symbol - 1 - i)) & 1
        j = bit_index + i
        byte, off = divmod(j, 8)
        mask = 0x80 >> off
        if bit:
            dest[byte] |= mask
        else:
            dest[byte] &= ~mask & 0xFF
    return dest


def unpack_array(src, bit_index: int, bits_per_symbol: int) -> int:
    """Extract one symbol from a packed byte array at a bit offset
    (liquid liquid_unpack_array)."""
    src = np.asarray(src, dtype=np.uint8)
    total_bits = src.size * 8
    if bit_index + bits_per_symbol > total_bits:
        raise ConfigError("symbol overruns array")
    sym = 0
    for i in range(bits_per_symbol):
        j = bit_index + i
        byte, off = divmod(j, 8)
        sym = (sym << 1) | ((int(src[byte]) >> (7 - off)) & 1)
    return sym


def lshift(x, b: int) -> np.ndarray:
    """Byte-wise left shift, zero-fill on the right (liquid_lshift)."""
    x = np.asarray(x, dtype=np.uint8)
    b = min(int(b), x.size)
    return np.concatenate([x[b:], np.zeros(b, dtype=np.uint8)])


def rshift(x, b: int) -> np.ndarray:
    """Byte-wise right shift, zero-fill on the left (liquid_rshift)."""
    x = np.asarray(x, dtype=np.uint8)
    b = min(int(b), x.size)
    return np.concatenate([np.zeros(b, dtype=np.uint8), x[: x.size - b]])


def lcircshift(x, b: int) -> np.ndarray:
    """Byte-wise circular left shift (liquid_lcircshift)."""
    x = np.asarray(x, dtype=np.uint8)
    return np.roll(x, -int(b) % max(x.size, 1))


def rcircshift(x, b: int) -> np.ndarray:
    """Byte-wise circular right shift (liquid_rcircshift)."""
    x = np.asarray(x, dtype=np.uint8)
    return np.roll(x, int(b) % max(x.size, 1))


def _bits_of(x: np.ndarray) -> np.ndarray:
    return _to_bits(x, 8)


def lbshift(x, b: int) -> np.ndarray:
    """Bit-wise left shift across byte boundaries (liquid_lbshift)."""
    x = np.asarray(x, dtype=np.uint8)
    bits = _bits_of(x)
    b = min(int(b), bits.size)
    bits = np.concatenate([bits[b:], np.zeros(b, dtype=np.uint8)])
    return _from_bits(bits, 8)


def rbshift(x, b: int) -> np.ndarray:
    """Bit-wise right shift across byte boundaries (liquid_rbshift)."""
    x = np.asarray(x, dtype=np.uint8)
    bits = _bits_of(x)
    b = min(int(b), bits.size)
    bits = np.concatenate([np.zeros(b, dtype=np.uint8), bits[: bits.size - b]])
    return _from_bits(bits, 8)


def lbcircshift(x, b: int) -> np.ndarray:
    """Bit-wise circular left shift (liquid_lbcircshift)."""
    x = np.asarray(x, dtype=np.uint8)
    bits = _bits_of(x)
    return _from_bits(np.roll(bits, -int(b) % max(bits.size, 1)), 8)


def rbcircshift(x, b: int) -> np.ndarray:
    """Bit-wise circular right shift (liquid_rbcircshift)."""
    x = np.asarray(x, dtype=np.uint8)
    bits = _bits_of(x)
    return _from_bits(np.roll(bits, int(b) % max(bits.size, 1)), 8)


def unwrap_phase(theta) -> np.ndarray:
    """Unwrap a phase trajectory by ±2π steps (liquid_unwrap_phase)."""
    return np.unwrap(np.asarray(theta, dtype=np.float64)).astype(np.float32)


def sumsqf(x) -> float:
    """Sum of squares of a real vector (liquid sumsqf)."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.sum(x * x))


def sumsqcf(x) -> float:
    """Sum of |·|² of a complex vector (liquid sumsqcf)."""
    x = np.asarray(x)
    return float(np.sum((x * np.conj(x)).real))
