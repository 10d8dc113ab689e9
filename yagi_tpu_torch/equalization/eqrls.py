"""RLS adaptive equalizer.

Port of :mod:`yagi_tpu.equalization.eqrls` (behavioral spec: eqrls.rs).
P-matrix recursion per training step (eqrls.rs:112-146):

  ζ = x·P₀·xᴴ + λ;  g = P₀·xᴴ/ζ;  P₁ = P₀/λ − (g·x/λ)·P₀;  w₁ = w₀ + α·g

in yagi_tpu's order of operations. The reference's execute is an
unconjugated dot product w·r (eqrls.rs:108), unlike Eqlms. ``train_block``
runs the steps sample by sample in plain torch, batched over channels (a
p × p update of P each step); no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError

__all__ = ["Eqrls"]


@struct.state
class Eqrls:
    """RLS equalizer state (eqrls.rs:8-24)."""

    p: int = struct.static_field()
    lam: torch.Tensor = struct.field()  # forgetting factor
    h0: torch.Tensor = struct.field()
    w: torch.Tensor = struct.field()  # [..., p]
    P: torch.Tensor = struct.field()  # [..., p, p]
    buffer: torch.Tensor = struct.field()  # [..., p] oldest..newest

    delta: float = struct.static_field()

    @classmethod
    def create(cls, h=None, p: int | None = None, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "Eqrls":
        device = resolve_device(device)
        if h is not None:
            h0 = np.asarray(h).astype(np.complex64)
            p = len(h0)
        else:
            if p is None or p == 0:
                raise ConfigError("equalizer length must be greater than 0")
            h0 = np.zeros(p, dtype=np.complex64)
            h0[p - 1] = 1.0
        delta = 0.1
        P0 = torch.from_numpy(np.eye(p, dtype=np.complex64) / delta).to(device)
        h0 = torch.from_numpy(h0).to(device)
        shape = tuple(batch_shape)
        return cls(
            p=p,
            lam=torch.tensor(0.99, dtype=torch.float32, device=device),
            h0=h0,
            w=h0.expand(shape + (p,)).clone(),
            P=P0.expand(shape + (p, p)).clone(),
            buffer=torch.zeros(shape + (p,), dtype=dtype, device=device),
            delta=delta,
        )

    def reset(self) -> "Eqrls":
        P0 = torch.eye(self.p, dtype=self.P.dtype, device=self.P.device) / self.delta
        return self.replace(
            w=self.h0.expand(self.w.shape).clone(),
            P=P0.expand(self.P.shape).clone(),
            buffer=torch.zeros_like(self.buffer),
        )

    def set_bw(self, lam) -> "Eqrls":
        if isinstance(lam, (int, float)) and not (0.0 <= lam <= 1.0):
            raise ConfigError("learning rate must be in (0,1)")
        return self.replace(lam=torch.as_tensor(lam, dtype=torch.float32, device=self.w.device))

    def get_bw(self):
        return self.lam

    def get_weights(self):
        """User-facing taps: the conjugate-reversed weights (eqrls.rs:148-156)."""
        return self.w.flip(-1).conj().resolve_conj()

    def push(self, x) -> "Eqrls":
        x = torch.as_tensor(x, device=self.buffer.device).to(self.buffer.dtype)
        x = torch.broadcast_to(x, self.buffer.shape[:-1])
        return self.replace(buffer=torch.cat([self.buffer[..., 1:], x[..., None]], -1))

    def execute(self):
        """y = w·r, unconjugated (eqrls.rs:105-110)."""
        return (self.w * self.buffer).sum(-1)

    def step(self, d, d_hat) -> "Eqrls":
        """One RLS update (eqrls.rs:112-146)."""
        dev = self.w.device
        alpha = torch.as_tensor(d, device=dev) - torch.as_tensor(d_hat, device=dev)
        x = self.buffer  # [..., p]
        P0 = self.P
        lam = self.lam
        xc = x.conj()

        xp0 = (x[..., None, :] @ P0)[..., 0, :]  # x·P0
        zeta = (xp0 * xc).sum(-1) + lam
        g = (P0 @ xc[..., None])[..., 0] / zeta[..., None]
        gxl = g[..., :, None] * x[..., None, :] / lam
        P1 = P0 / lam - gxl @ P0
        w1 = self.w + alpha[..., None] * g
        return self.replace(w=w1.to(self.w.dtype), P=P1.to(self.P.dtype))

    def train_block(self, x, d) -> tuple[torch.Tensor, "Eqrls"]:
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
        if not ys:
            return torch.empty_like(x), eq
        return torch.stack(ys, -1), eq
