"""LMS adaptive equalizer.

Port of :mod:`yagi_tpu.equalization.eqlms` (behavioral spec: eqlms.rs).
Weight update normalized by the windowed input energy: w ← w + μ·conj(α)·r /
Σ|x|² (eqlms.rs:170-187); the blind constant-modulus update uses d = d̂/|d̂|
(eqlms.rs:189-192); fractionally spaced operation trains every k-th sample
(eqlms.rs:153-168). The training loops run sample by sample in plain torch,
batched over channels. QamRx does not call them: its equalizer runs inside
the ``qam_eq_scan`` kernel (:mod:`yagi_tpu_torch.kernels.qam`) on this
object's state.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .. import design

__all__ = ["Eqlms"]


@struct.state
class Eqlms:
    """LMS equalizer state (eqlms.rs:7-18).

    ``buffer`` holds the last h_len inputs oldest..newest; execute =
    Σ conj(w[i])·buffer[i] (eqlms.rs:137-140).
    """

    h_len: int = struct.static_field()
    mu: torch.Tensor = struct.field()
    h0: torch.Tensor = struct.field()  # [h_len] initial weights
    w: torch.Tensor = struct.field()  # [..., h_len] current weights
    buffer: torch.Tensor = struct.field()  # [..., h_len]
    x2: torch.Tensor = struct.field()  # [..., h_len] |x|² window
    x2_sum: torch.Tensor = struct.field()
    count: torch.Tensor = struct.field()  # int32 samples pushed

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, h=None, h_len: int | None = None, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "Eqlms":
        """From initial taps h (conjugate-reversed internally,
        eqlms.rs:39-45), or the identity (a center tap) if h is None."""
        device = resolve_device(device)
        if h is not None:
            h = np.asarray(h)
            h_len = len(h)
            h0 = np.conj(h[::-1]).astype(np.complex64)
        else:
            if h_len is None:
                raise ConfigError("either h or h_len must be given")
            h0 = np.zeros(h_len, dtype=np.complex64)
            h0[h_len // 2] = 1.0
        h0 = torch.from_numpy(h0).to(device)
        shape = tuple(batch_shape) + (h_len,)
        return cls(
            h_len=h_len,
            mu=torch.tensor(0.5, dtype=torch.float32, device=device),
            h0=h0,
            w=h0.expand(shape).clone(),
            buffer=torch.zeros(shape, dtype=dtype, device=device),
            x2=torch.zeros(shape, dtype=torch.float32, device=device),
            x2_sum=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            count=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        )

    @classmethod
    def create_rnyquist(cls, ftype, k: int, m: int, beta: float, dt: float = 0.0,
                        **kw) -> "Eqlms":
        """Square-root Nyquist matched-filter initialization (eqlms.rs:51);
        ``ftype`` a :class:`~yagi_tpu_torch.design.FirFilterShape` or its
        name."""
        if k < 2:
            raise ConfigError("samples/symbol must be greater than 1")
        if m == 0:
            raise ConfigError("filter delay must be greater than 0")
        if not 0.0 <= beta <= 1.0:
            raise ConfigError("filter excess bandwidth factor must be in [0,1]")
        if not -1.0 <= dt <= 1.0:
            raise ConfigError("filter fractional sample delay must be in [-1,1]")
        if isinstance(ftype, str):
            ftype = design.FirFilterShape.from_str(ftype)
        return cls.create(h=design.fir_design_prototype(ftype, k, m, beta, dt) / k, **kw)

    @classmethod
    def create_lowpass(cls, h_len: int, fc: float, **kw) -> "Eqlms":
        """Lowpass initialization (eqlms.rs:78)."""
        if h_len == 0:
            raise ConfigError("filter length must be greater than 0")
        if not 0.0 < fc <= 0.5:
            raise ConfigError("filter cutoff must be in (0,0.5]")
        return cls.create(h=design.fir_design_kaiser(h_len, fc, 40.0, 0.0) * 2.0 * fc, **kw)

    # ---------------------------------------------------------------- control
    def reset(self) -> "Eqlms":
        return self.replace(
            w=self.h0.expand(self.w.shape).clone(),
            buffer=torch.zeros_like(self.buffer),
            x2=torch.zeros_like(self.x2),
            x2_sum=torch.zeros_like(self.x2_sum),
            count=torch.zeros_like(self.count),
        )

    def set_bw(self, mu) -> "Eqlms":
        if isinstance(mu, (int, float)) and mu < 0.0:
            raise ConfigError("learning rate cannot be less than zero")
        return self.replace(mu=torch.as_tensor(mu, dtype=torch.float32, device=self.w.device))

    def get_bw(self):
        return self.mu

    def get_weights(self):
        """User-facing taps: the conjugate-reversed internal weights
        (eqlms.rs:121)."""
        return self.w.flip(-1).conj().resolve_conj()

    # ------------------------------------------------------------- primitives
    def push(self, x) -> "Eqlms":
        """Push one sample per channel (eqlms.rs:125)."""
        x = torch.as_tensor(x, device=self.buffer.device).to(self.buffer.dtype)
        x2n = x.abs().square()
        return self.replace(
            buffer=torch.cat([self.buffer[..., 1:], x[..., None]], -1),
            x2=torch.cat([self.x2[..., 1:], x2n[..., None]], -1),
            x2_sum=self.x2_sum + x2n - self.x2[..., 0],
            count=self.count + 1,
        )

    def execute(self):
        """Current output Σ conj(w)·buffer (eqlms.rs:137)."""
        return (self.w.conj() * self.buffer).sum(-1)

    def step(self, d, d_hat) -> "Eqlms":
        """Training update toward d (eqlms.rs:170-187); inactive until the
        buffer has filled."""
        dev = self.w.device
        alpha = torch.as_tensor(d, device=dev) - torch.as_tensor(d_hat, device=dev)
        upd = self.w + (self.mu * alpha.conj()[..., None] * self.buffer) / torch.clamp(
            self.x2_sum[..., None], min=1e-20)
        ready = (self.count >= self.h_len)[..., None]
        return self.replace(w=torch.where(ready, upd.to(self.w.dtype), self.w))

    def step_blind(self, d_hat) -> "Eqlms":
        """Constant-modulus blind update (eqlms.rs:189)."""
        d_hat = torch.as_tensor(d_hat, device=self.w.device)
        return self.step(d_hat / torch.clamp(d_hat.abs(), min=1e-20), d_hat)

    # --------------------------------------------------------------- training
    def train_block(self, x, d) -> tuple[torch.Tensor, "Eqlms"]:
        """Supervised training over (x, d) pairs [..., n]: per sample push,
        y = execute, update toward d. Returns the outputs y [..., n]."""
        x = torch.as_tensor(x, device=self.w.device).to(self.buffer.dtype)
        d = torch.as_tensor(d, device=self.w.device).to(self.buffer.dtype)
        eq, ys = self, []
        for t in range(x.shape[-1]):
            eq = eq.push(x[..., t])
            y = eq.execute()
            eq = eq.step(d[..., t], y)
            ys.append(y)
        return torch.stack(ys, -1), eq

    def execute_block(self, k: int, x) -> tuple[torch.Tensor, "Eqlms"]:
        """Blind decision-directed processing (eqlms.rs:153-168): an output
        every sample, a constant-modulus update every k-th."""
        if k == 0:
            raise ConfigError("down-sampling rate 'k' must be greater than 0")
        x = torch.as_tensor(x, device=self.w.device).to(self.buffer.dtype)
        eq, ys = self, []
        for t in range(x.shape[-1]):
            eq = eq.push(x[..., t])
            y = eq.execute()
            do_update = ((eq.count + k - 1) % k) == 0
            eq = eq.replace(w=torch.where(do_update[..., None], eq.step_blind(y).w, eq.w))
            ys.append(y)
        return torch.stack(ys, -1), eq

    def decim_execute(self, x, k: int):
        """Push k samples x [..., k], output after the first
        (eqlms.rs:142-151)."""
        x = torch.as_tensor(x, device=self.w.device)
        eq = self.push(x[..., 0])
        y = eq.execute()
        for i in range(1, k):
            eq = eq.push(x[..., i])
        return y, eq
