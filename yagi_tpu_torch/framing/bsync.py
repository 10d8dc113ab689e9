"""BSync: binary (hard-limited) correlator synchronizer.

Port of :mod:`yagi_tpu.framing.bsync` (behavioral spec: liquid-dsp's
``bsync_rrrf``/``bsync_crcf``): the synchronizer hard-limits the incoming
stream to sign bits and correlates them against a known binary sequence;
the output ``rxy`` is the normalized bit agreement in [-1, 1] (complex for
complex input: I and Q correlated independently). Only signs enter the
correlation, so the detector ignores amplitude fading.

Where it runs: on the object's device, a block of samples as one banded
matmul of the sign stream with the ±1 template
(:func:`~yagi_tpu_torch.filter._conv.causal_conv_valid`) — [..., N] in,
[..., N] rxy out — with an explicit carry of the last n−1 signs so block
boundaries are seamless. Every product is ±1 and every sum an integer
below 2^24, so the float32 result is exact in any summation order (and in
TF32, which holds ±1 exactly); the normalization multiplies by the float32
1/n, as XLA compiles yagi_tpu's division by n: card, CPU and yagi_tpu agree
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..filter._conv import causal_conv_valid

__all__ = ["BSync"]


def _signs(x: torch.Tensor) -> torch.Tensor:
    """sign(x), with 0 taken as +1, as float32."""
    return (torch.sign(x) + (x == 0)).to(torch.float32)


class BSync:
    """Binary correlator over a ±1 sequence, on ``device`` (the current CUDA
    device by default).

    ``execute_block(x, state)`` returns the per-sample normalized
    correlation ``rxy`` (the shape of ``x``; complex input gives complex
    rxy with I and Q correlated independently) and the updated carry state
    (the last n−1 signs, [..., n−1] float32, a pair for complex input).
    ``rxy[k]`` is the correlation of the window *ending* at sample k, as
    liquid's one-sample-at-a-time ``bsync_execute``.
    """

    def __init__(self, sequence, device=None):
        self.device = resolve_device(device)
        if isinstance(sequence, torch.Tensor):
            sequence = sequence.cpu().numpy()
        seq = np.asarray(sequence, dtype=np.float32).ravel()
        if seq.size == 0:
            raise ConfigError("sequence length must be > 0")
        self.n = int(seq.size)
        template = (np.sign(seq) + (seq == 0)).astype(np.float32)
        # causal_conv_valid's taps: h[j] = template[n − 1 − j], so that
        # rxy[k] = Σ_i template[i]·full[k + i]
        self._h = torch.from_numpy(template[::-1].copy()).to(self.device)
        self._inv_n = torch.tensor(1.0 / self.n, dtype=torch.float32, device=self.device)

    @classmethod
    def from_msequence(cls, ms, device=None) -> "BSync":
        """Template from an m-sequence (bits 0/1 → ∓1)."""
        bits = ms.generate_bits(ms.get_length())
        return cls(2.0 * np.asarray(bits, np.float32) - 1.0, device=device)

    def _corr(self, signs: torch.Tensor, carry) -> tuple[torch.Tensor, torch.Tensor]:
        if carry is None:
            carry = signs.new_zeros(signs.shape[:-1] + (self.n - 1,))
        if not isinstance(carry, torch.Tensor):
            carry = torch.from_numpy(np.array(carry, dtype=np.float32))
        carry = carry.to(self.device, torch.float32)
        full = torch.cat([carry, signs], -1)
        rxy = causal_conv_valid(full, self._h) * self._inv_n
        return rxy, full[..., full.shape[-1] - (self.n - 1):]

    def execute_block(self, x, state=None):
        """x [..., N] (a tensor or anything numpy takes) → (rxy [..., N],
        the new state)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        x = x.to(self.device)
        if x.is_complex():
            ci, cq = (None, None) if state is None else state
            ri, ci = self._corr(_signs(x.real), ci)
            rq, cq = self._corr(_signs(x.imag), cq)
            return torch.complex(ri, rq), (ci, cq)
        return self._corr(_signs(x), state)
