"""Packed binary sequence (host-side, NumPy uint32 words).

Copied from :mod:`yagi_tpu.sequence.bsequence` (the reference's
sequence/bsequence.rs): a bit sequence packed into 32-bit words (newest bit
pushed in from the right), with correlate/add/mul/accumulate and Golay
complementary-code construction (bsequence.rs:34-79). These drive code
design and tests, not the sample-rate path.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = ["BSequence"]


class BSequence:
    """Packed bit sequence (bsequence.rs:8-13)."""

    def __init__(self, num_bits: int):
        s_len = (num_bits + 31) // 32
        self.num_bits = num_bits
        self.num_bits_msb = 32 if num_bits % 32 == 0 else num_bits % 32
        self.bit_mask_msb = (1 << self.num_bits_msb) - 1 if self.num_bits_msb < 32 else 0xFFFFFFFF
        self.s = np.zeros(s_len, dtype=np.uint32)

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create_ccodes(cls, num_bits: int) -> tuple["BSequence", "BSequence"]:
        """Golay complementary code pair (bsequence.rs:34-79)."""
        if num_bits < 8:
            raise ConfigError("sequence too short")
        if num_bits % 8 != 0:
            raise ConfigError("sequence must be multiple of 8")
        num_bytes = num_bits // 8
        a = bytearray(num_bytes)
        b = bytearray(num_bytes)
        a[num_bytes - 1] = 0xB8
        b[num_bytes - 1] = 0xB7
        n = 1
        while n < num_bytes:
            i_n1 = num_bytes - n
            i_n0 = num_bytes - 2 * n
            a_tail = bytes(a[i_n1 : i_n1 + n])
            b_tail = bytes(b[i_n1 : i_n1 + n])
            a[i_n0:i_n1] = a_tail
            b[i_n0:i_n1] = a_tail
            a[i_n1 : i_n1 + n] = b_tail
            for i in range(n):
                b[num_bytes - i - 1] ^= 0xFF
            n *= 2
        qa = cls(num_bits)
        qb = cls(num_bits)
        qa.init(bytes(a))
        qb.init(bytes(b))
        return qa, qb

    @classmethod
    def from_msequence(cls, ms) -> "BSequence":
        """Fill from an m-sequence (bsequence.rs:81-88)."""
        bs = cls(ms.get_length())
        for _ in range(ms.get_length()):
            bs.push(ms.advance())
        return bs

    # --------------------------------------------------------------- mutation
    def reset(self) -> None:
        self.s[:] = 0

    def init(self, v: bytes) -> None:
        """Load from packed bytes, MSB first (bsequence.rs:95-108)."""
        k = 0
        byte = 0
        mask = 0
        for i in range(self.num_bits):
            if i % 8 == 0:
                byte = v[k]
                k += 1
                mask = 0x80
            self.push(1 if (byte & mask) else 0)
            mask >>= 1

    def push(self, bit: int) -> None:
        """Shift left, insert bit at LSB (bsequence.rs:115-128)."""
        self.s[0] = (int(self.s[0]) << 1) & self.bit_mask_msb
        for i in range(1, len(self.s)):
            overflow = (int(self.s[i]) >> 31) & 1
            self.s[i] = (int(self.s[i]) << 1) & 0xFFFFFFFF
            self.s[i - 1] |= np.uint32(overflow)
        self.s[-1] |= np.uint32(bit & 1)

    def circshift(self) -> None:
        """Circular left shift (bsequence.rs:130-135)."""
        msb_mask = 1 << (self.num_bits_msb - 1)
        b = (int(self.s[0]) & msb_mask) >> (self.num_bits_msb - 1)
        self.push(b)

    # ------------------------------------------------------------ operations
    def correlate(self, other: "BSequence") -> int:
        """# agreeing bits − # disagreeing... liquid counts agreements
        (bsequence.rs:137-151)."""
        if len(self.s) != len(other.s):
            raise ConfigError("binary sequences must be the same length")
        rxy = 0
        for a, b in zip(self.s, other.s):
            rxy += bin((~(int(a) ^ int(b))) & 0xFFFFFFFF).count("1")
        rxy -= 32 - self.num_bits_msb
        return rxy

    def add(self, other: "BSequence") -> "BSequence":
        """Modulo-2 addition = XOR (bsequence.rs:153-164)."""
        if len(self.s) != len(other.s):
            raise ConfigError("binary sequences must be same length")
        out = BSequence(self.num_bits)
        out.s = self.s ^ other.s
        return out

    def mul(self, other: "BSequence") -> "BSequence":
        """Bit-wise multiplication = AND (bsequence.rs:166-177)."""
        if len(self.s) != len(other.s):
            raise ConfigError("binary sequences must be same length")
        out = BSequence(self.num_bits)
        out.s = self.s & other.s
        return out

    def accumulate(self) -> int:
        """Count of ones (bsequence.rs:179-181)."""
        return int(sum(bin(int(w)).count("1") for w in self.s))

    def get_length(self) -> int:
        return self.num_bits

    def index(self, i: int) -> int:
        """i-th bit, LSB-side indexing (bsequence.rs:188-195)."""
        if i >= self.num_bits:
            raise ConfigError(f"invalid index {i}")
        k = len(self.s) - 1 - i // 32
        return (int(self.s[k]) >> (i % 32)) & 1

    def to_array(self) -> np.ndarray:
        """Bits as 0/1 array, oldest-first."""
        return np.asarray(
            [self.index(self.num_bits - 1 - i) for i in range(self.num_bits)],
            dtype=np.uint8,
        )
