"""Block bit-interleaver (liquid ``interleaver`` analog).

Fills the reference's empty fec module; behavioral spec: liquid-dsp's
interleaver object (create(n), encode/decode as permutation and inverse,
used inside the packetizer to spread burst errors across FEC blocks).

Design: a coprime-stride bit permutation ``pi(i) = (i * s) mod (8n)`` with
``s`` the integer nearest golden-ratio x 8n that is coprime to 8n. Any
channel burst of length B <= 8n/s lands in de-interleaved positions that
are pairwise >= min(s, 8n-s) bits apart — a provable minimum spread, unlike
row/column transposes which can re-cluster under composition. The
permutation is precomputed once at construction (host); application is a
single gather, batched over leading dims.

Copied from :mod:`yagi_tpu.fec.interleave`. Where it runs: the byte
permutations are packet-rate work on the host in numpy, as in yagi_tpu.
:class:`~yagi_tpu_torch.fec.Packetizer` applies the outer permutation to
soft levels on its device (a gather), from ``_iperm``.
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import ConfigError
from ._bits import pack_bits, unpack_bits

__all__ = ["Interleaver"]


def _coprime_stride(total: int) -> int:
    target = max(1, round(total * 0.6180339887))
    for d in range(total):
        for cand in (target - d, target + d):
            if 1 <= cand < total and math.gcd(cand, total) == 1:
                return cand
    return 1


class Interleaver:
    """Bit interleaver over n-byte messages."""

    def __init__(self, n: int, depth: int = 2):
        if n < 1:
            raise ConfigError(f"interleaver length n ({n}) must be >= 1")
        if depth < 0:
            raise ConfigError(f"depth ({depth}) must be >= 0")
        self.n = n
        self.depth = depth
        total = 8 * n
        s = _coprime_stride(total)
        if depth == 0:
            perm = np.arange(total, dtype=np.int64)
        else:
            perm = (np.arange(total, dtype=np.int64) * s) % total
        self._perm = perm
        self._iperm = np.argsort(perm)

    def encode(self, data) -> np.ndarray:
        """Interleave byte message [..., n] -> [..., n]."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-1] != self.n:
            raise ConfigError(f"message length {data.shape[-1]} != n ({self.n})")
        bits = unpack_bits(data)
        return pack_bits(bits[..., self._perm])

    def decode(self, data) -> np.ndarray:
        """Inverse permutation."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-1] != self.n:
            raise ConfigError(f"message length {data.shape[-1]} != n ({self.n})")
        bits = unpack_bits(data)
        return pack_bits(bits[..., self._iperm])

    def encode_soft(self, soft) -> np.ndarray:
        """Interleave soft bits [..., 8n] (one value per bit).

        Same permutation applied to per-bit soft metrics, the reference's
        ``interleaver_encode_soft`` (liquid interleaver_soft_* autotests):
        soft channel values must ride the identical spread so the FEC's
        soft decoder sees them in de-interleaved order.
        """
        soft = np.asarray(soft)
        if soft.shape[-1] != 8 * self.n:
            raise ConfigError(
                f"soft length {soft.shape[-1]} != 8n ({8 * self.n})")
        return soft[..., self._perm]

    def decode_soft(self, soft) -> np.ndarray:
        """Inverse soft-bit permutation [..., 8n]."""
        soft = np.asarray(soft)
        if soft.shape[-1] != 8 * self.n:
            raise ConfigError(
                f"soft length {soft.shape[-1]} != 8n ({8 * self.n})")
        return soft[..., self._iperm]
