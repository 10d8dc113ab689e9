"""CVSD — continuously variable slope delta audio codec.

Port of :mod:`yagi_tpu.audio.cvsd` (semantics of liquid's cvsd, autotests
cvsd_rmse_sine / cvsd_invalid_config, LIQUID_COMPAT.md:29-34):

* 1-bit delta modulation: each bit says whether the tracked reference is
  below (1) or above (0) the input; the reference moves by an adaptive step.
* Syllabic companding: when the last ``num_bits`` output bits are identical
  (slope overload) the step grows by ``zeta``; otherwise it decays by
  ``1/zeta``, clamped to [delta_min, delta_max].
* ``alpha`` sets a symmetric one-pole pre-emphasis (encode) / de-emphasis
  (decode) pair so the delta loop tracks the differentiated signal.

Encoder and decoder run the same step-size automaton, so a decoder fed the
encoder's bits reproduces the encoder's reference exactly.

Where it runs: on the state's device, batched over channels. The
pre-emphasis x[n] − α·x[n−1] is one vectorized operation before the loop;
the delta loop (and the decoder's de-emphasis recurrence) is a torch loop
over the samples, yagi_tpu's ``lax.scan`` (``cvsd.py:112,134``), every
operation rounded alone in float32 as yagi_tpu writes it. ``bitref`` is a
u32 held as int64 and masked, as the port keeps every u32.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import last
from ..errors import ConfigError

__all__ = ["Cvsd"]

_DELTA_MIN = 0.01
_DELTA_MAX = 1.0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@struct.state
class Cvsd:
    """CVSD codec state (shared by the encode and decode directions)."""

    num_bits: int = struct.static_field()
    zeta: float = struct.static_field()
    alpha: float = struct.static_field()
    ref: torch.Tensor = struct.field()  # tracked reference v
    delta: torch.Tensor = struct.field()  # adaptive step
    bitref: torch.Tensor = struct.field()  # last num_bits bits (u32 as int64)
    pre_state: torch.Tensor = struct.field()  # pre-emphasis x[n-1]
    post_state: torch.Tensor = struct.field()  # de-emphasis y[n-1]

    @classmethod
    def create(cls, num_bits: int = 4, zeta: float = 1.5, alpha: float = 0.9,
               batch_shape: tuple = (), device=None) -> "Cvsd":
        device = resolve_device(device)
        if num_bits == 0:
            raise ConfigError("number of bits must be positive")
        if zeta <= 1.0:
            raise ConfigError("zeta must be greater than 1")
        if not 0.0 <= alpha < 1.0:
            raise ConfigError("alpha must be in [0, 1)")
        z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
        return cls(
            num_bits=num_bits, zeta=float(zeta), alpha=float(alpha),
            ref=z, delta=torch.full(batch_shape, _DELTA_MIN, dtype=torch.float32, device=device),
            bitref=torch.zeros(batch_shape, dtype=torch.int64, device=device),
            pre_state=z.clone(), post_state=z.clone(),
        )

    def reset(self) -> "Cvsd":
        return self.replace(
            ref=torch.zeros_like(self.ref), delta=torch.full_like(self.delta, _DELTA_MIN),
            bitref=torch.zeros_like(self.bitref), pre_state=torch.zeros_like(self.pre_state),
            post_state=torch.zeros_like(self.post_state))

    def _loop(self, n: int, decide, after=None):
        """The shared companding automaton over n samples: per sample the
        bit ``decide(t, ref)`` (int64 0/1), the bit history, the step
        growth or decay, the reference; ``after(t, ref)`` then sees the new
        reference. Returns (the bits [..., n] uint8, ref, delta, bitref)."""
        ref, delta, bitref = self.ref, self.delta, self.bitref
        mask = (1 << self.num_bits) - 1
        # the decay divides by zeta as XLA compiles yagi_tpu's division by a
        # constant: a multiply by the float32 1/zeta
        zeta, inv = _f32(self.zeta, ref), _f32(1.0 / self.zeta, ref)
        lo, hi = _f32(_DELTA_MIN, ref), _f32(_DELTA_MAX, ref)
        r_lo, r_hi = _f32(-1.5, ref), _f32(1.5, ref)
        bits = torch.empty(ref.shape + (n,), dtype=torch.uint8, device=ref.device)
        for t in range(n):
            bit = decide(t, ref)
            bits[..., t] = bit
            bitref = ((bitref << 1) | bit) & mask
            overload = (bitref == mask) | (bitref == 0)
            delta = torch.clamp(torch.where(overload, delta * zeta, delta * inv), lo, hi)
            ref = torch.clamp(ref + torch.where(bit == 1, delta, -delta), r_lo, r_hi)
            if after is not None:
                after(t, ref)
        return bits, ref, delta, bitref

    def encode(self, x) -> tuple[torch.Tensor, "Cvsd"]:
        """Audio [..., N] in ~[-1, 1] → bits uint8 [..., N]."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, dtype=np.float32))
        x = x.to(self.ref.device, torch.float32)
        prev = torch.cat([self.pre_state[..., None], x[..., :-1]], -1)
        v = x - _f32(self.alpha, x) * prev  # pre-emphasis
        bits, ref, delta, bitref = self._loop(
            x.shape[-1], lambda t, r: (v[..., t] > r).to(torch.int64))
        return bits, self.replace(ref=ref, delta=delta, bitref=bitref,
                                  pre_state=last(x, self.pre_state))

    def decode(self, bits) -> tuple[torch.Tensor, "Cvsd"]:
        """Bits uint8 [..., N] (any nonzero value counts as 1) → audio
        [..., N] float32."""
        b = bits if isinstance(bits, torch.Tensor) else torch.from_numpy(np.array(bits))
        b = b.to(self.ref.device)
        b = (b != 0).to(torch.int64)
        alpha = _f32(self.alpha, self.ref)
        y = torch.empty(b.shape, dtype=torch.float32, device=self.ref.device)
        post = [self.post_state]

        def emphasis(t, ref):  # de-emphasis y = ref + α·y[n−1]
            post[0] = ref + alpha * post[0]
            y[..., t] = post[0]

        _, ref, delta, bitref = self._loop(b.shape[-1], lambda t, r: b[..., t], emphasis)
        return y, self.replace(ref=ref, delta=delta, bitref=bitref, post_state=post[0])
