"""Maximal-length (m-)sequence LFSR (host-side Python ints).

Copied from :mod:`yagi_tpu.sequence.msequence` (the reference's
sequence/msequence.rs): feedback bit b = parity(state & g), state ←
((state<<1)|b) & n (msequence.rs:116-122), default generator polynomials for
m∈[2,31] (msequence.rs:8-37). It drives signal generators at symbol rate, so
it stays on the host; ``measure_period`` takes the multiplicative order of
the GF(2) update matrix.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = ["MSequence"]

_GENPOLY = {
    2: 0x00000003, 3: 0x00000006, 4: 0x0000000C, 5: 0x00000014,
    6: 0x00000030, 7: 0x00000060, 8: 0x000000B8, 9: 0x00000110,
    10: 0x00000240, 11: 0x00000500, 12: 0x00000E08, 13: 0x00001C80,
    14: 0x00003802, 15: 0x00006000, 16: 0x0000D008, 17: 0x00012000,
    18: 0x00020400, 19: 0x00072000, 20: 0x00090000, 21: 0x00140000,
    22: 0x00300000, 23: 0x00420000, 24: 0x00E10000, 25: 0x01000004,
    26: 0x02000023, 27: 0x04000013, 28: 0x08000004, 29: 0x10000002,
    30: 0x20000029, 31: 0x40000004,
}


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


class MSequence:
    """LFSR m-sequence generator (msequence.rs:40-47)."""

    def __init__(self, m: int, g: int, a: int = 1):
        if m < 2 or m > 31:
            raise ConfigError(f"m ({m}) not in range [2,31]")
        self.m = m
        self.g = g
        self.a = a
        self.n = (1 << m) - 1
        self.state = a

    @classmethod
    def create_default(cls, m: int) -> "MSequence":
        """Default generator polynomial for m (msequence.rs:80-118)."""
        if m not in _GENPOLY:
            raise ConfigError(f"m ({m}) not in range [2,31]")
        return cls.create_genpoly(_GENPOLY[m])

    @classmethod
    def create_genpoly(cls, g: int) -> "MSequence":
        """From generator polynomial; m = 1-based msb index = bit_length
        (msequence.rs:72-78, utility msb_index)."""
        t = g.bit_length()
        if t < 2:
            raise ConfigError(f"invalid generator polynomial: 0x{g:x}")
        return cls(t, g, 1)

    def advance(self) -> int:
        """One LFSR step, returns the feedback bit (msequence.rs:116-122)."""
        b = _parity(self.state & self.g)
        self.state = ((self.state << 1) | b) & self.n
        return b

    def measure_period(self) -> int:
        """Sequence period (msequence.rs:144-158 measure_period).

        Computed exactly as the multiplicative order of the GF(2)
        state-update matrix (order divides 2^m − 1), instead of the
        reference's step-until-repeat loop — identical result, O(m³·log)
        instead of O(2^m) work, so period checks up to m = 31 stay fast.
        """
        t = self.m
        M = np.zeros((t, t), dtype=np.uint8)
        for j in range(t):
            M[0, j] = (self.g >> j) & 1  # feedback row: b = parity(s & g)
        for i in range(1, t):
            M[i, i - 1] = 1  # shift row: new bit i = old bit i-1

        def matmul2(a, b):
            return (a.astype(np.uint32) @ b.astype(np.uint32) & 1).astype(np.uint8)

        def matpow2(a, e):
            r = np.eye(t, dtype=np.uint8)
            while e:
                if e & 1:
                    r = matmul2(r, a)
                a = matmul2(a, a)
                e >>= 1
            return r

        n = (1 << t) - 1
        eye = np.eye(t, dtype=np.uint8)
        if not np.array_equal(matpow2(M, n), eye):
            # not primitive: fall back to direct cycle detection
            a0, count = self.state, 0
            s = a0
            while True:
                b = _parity(s & self.g)
                s = ((s << 1) | b) & self.n
                count += 1
                if s == a0 or count > n:
                    return count
        # order divides n: strip prime factors while the power stays I
        period = n
        rem, f = n, 2
        factors = set()
        while f * f <= rem:
            while rem % f == 0:
                factors.add(f)
                rem //= f
            f += 1
        if rem > 1:
            factors.add(rem)
        for p in factors:
            while period % p == 0 and np.array_equal(
                matpow2(M, period // p), eye
            ):
                period //= p
        return period

    def generate_symbol(self, bps: int) -> int:
        """bps feedback bits packed MSB-first (msequence.rs:124-131)."""
        s = 0
        for _ in range(bps):
            s = (s << 1) | self.advance()
        return s

    def generate_symbols(self, bps: int, count: int) -> np.ndarray:
        """Batch symbol generation (host-side, exact sequential LFSR)."""
        return np.asarray(
            [self.generate_symbol(bps) for _ in range(count)], dtype=np.uint32
        )

    def generate_bits(self, count: int) -> np.ndarray:
        return np.asarray([self.advance() for _ in range(count)], dtype=np.uint8)

    def reset(self) -> None:
        self.state = self.a

    def get_length(self) -> int:
        return self.n

    def get_genpoly(self) -> int:
        return self.g

    def get_genpoly_length(self) -> int:
        return self.m

    def get_state(self) -> int:
        return self.state

    def set_state(self, a: int) -> None:
        """Set shift register (must be non-zero for a maximal sequence)."""
        self.state = a & self.n
