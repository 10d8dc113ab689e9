"""Rational P/Q polyphase resampler.

Port of :mod:`yagi_tpu.filter.rresamp` (reference: rresamp.rs). For every Q
input samples the bank emits exactly P outputs through branches
(j·Q) mod P (rresamp.rs:144-185), a static emission schedule: output
o = blk·P + j fires after consuming input blk·Q + ⌊j·Q/P⌋. A block is one
banded matmul (filter/_sched.py), or, for heavy decimation where the band
matrix would be mostly zeros, a frame gather and one contraction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ._sched import sched_banded_matmul, sched_matmul_ok
from .firpfb import branch_dots, pfb_decompose

__all__ = ["Rresamp"]


@struct.state
class Rresamp:
    """Rational resampler state (rresamp.rs:8-15)."""

    p: int = struct.static_field()  # interpolation (numerator), gcd-reduced
    q: int = struct.static_field()  # decimation (denominator), gcd-reduced
    m: int = struct.static_field()  # filter semi-length
    block_len: int = struct.static_field()  # gcd
    branches: torch.Tensor = struct.field()  # [P, 2m] conv order
    scale: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()  # [..., 2m]

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, interp: int, decim: int, m: int, h, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "Rresamp":
        """From prototype h of length 2·interp·m (rresamp.rs:23-46)."""
        device = resolve_device(device)
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        if m == 0:
            raise ConfigError("filter semi-length must be greater than zero")
        h = np.asarray(h)
        branches = pfb_decompose(h[: 2 * interp * m], interp)
        branches = branches.astype(np.complex64 if np.iscomplexobj(h) else np.float32)
        return cls(
            p=interp,
            q=decim,
            m=m,
            block_len=1,
            branches=torch.from_numpy(branches).to(device),
            scale=torch.tensor(1.0, dtype=torch.float32, device=device),
            window=torch.zeros(batch_shape + (branches.shape[1],), dtype=dtype, device=device),
        )

    @classmethod
    def create_kaiser(cls, interp: int, decim: int, m: int = 12, bw: float = -1.0,
                      as_: float = 60.0, **kw) -> "Rresamp":
        """Kaiser prototype with liquid's bandwidth/scale rules (rresamp.rs:48-71)."""
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        g = math.gcd(interp, decim)
        interp_r, decim_r = interp // g, decim // g
        if bw < 0.0:
            bw = 0.5 if interp_r > decim_r else 0.5 * interp_r / decim_r
        elif bw > 0.5:
            raise ConfigError(f"invalid bandwidth ({bw}), must be less than 0.5")
        h_len = 2 * interp_r * m + 1
        hf = design.fir_design_kaiser(h_len, bw / interp_r, as_, 0.0)
        obj = cls.create(interp_r, decim_r, m, hf, **kw)
        obj = obj.set_scale(2.0 * bw * np.sqrt(obj.q / obj.p))
        return obj.replace(block_len=g)

    @classmethod
    def create_prototype(cls, ftype, interp: int, decim: int, m: int, beta: float,
                         **kw) -> "Rresamp":
        """(root-)Nyquist prototype (rresamp.rs:73-92)."""
        if interp == 0:
            raise ConfigError("interpolation rate must be greater than zero")
        if decim == 0:
            raise ConfigError("decimation rate must be greater than zero")
        g = math.gcd(interp, decim)
        interp_r, decim_r = interp // g, decim // g
        decim_flag = interp_r < decim_r
        k = decim_r if decim_flag else interp_r
        hf = design.fir_design_prototype(ftype, k, m, beta, 0.0)
        obj = cls.create(interp_r, decim_r, m, hf, **kw)
        rate = obj.p / obj.q
        obj = obj.set_scale(np.sqrt(rate) if decim_flag else 1.0 / np.sqrt(rate))
        return obj.replace(block_len=g)

    @classmethod
    def create_default(cls, interp: int, decim: int, **kw) -> "Rresamp":
        """m=12, bw=0.5, As=60 (rresamp.rs:95-100)."""
        return cls.create_kaiser(interp, decim, 12, 0.5, 60.0, **kw)

    # ------------------------------------------------------------ properties
    def get_rate(self) -> float:
        return self.p / self.q

    def get_p(self) -> int:
        return self.p * self.block_len

    def get_q(self) -> int:
        return self.q * self.block_len

    def get_interp(self) -> int:
        return self.p

    def get_decim(self) -> int:
        return self.q

    def get_block_len(self) -> int:
        return self.block_len

    def get_delay(self) -> int:
        return self.m

    @property
    def sub_len(self) -> int:
        return self.branches.shape[1]

    def reset(self) -> "Rresamp":
        return self.replace(window=torch.zeros_like(self.window))

    def set_scale(self, scale) -> "Rresamp":
        return self.replace(
            scale=torch.tensor(float(scale), dtype=torch.float32, device=self.scale.device))

    def get_scale(self):
        return self.scale

    def write(self, x) -> "Rresamp":
        """Push samples without producing output (rresamp.rs:141)."""
        x = torch.as_tensor(x, device=self.window.device)
        xa = torch.cat([self.window, x.to(self.window.dtype)], dim=-1)
        return self.replace(window=carry(self.window, xa))

    # ------------------------------------------------------------- streaming
    def execute_block(self, x) -> tuple[torch.Tensor, "Rresamp"]:
        """n·Q inputs → n·P outputs (rresamp.rs:144-160)."""
        x = torch.as_tensor(x, device=self.window.device)
        n_in = x.shape[-1]
        P, Q, L = self.p, self.q, self.sub_len
        if n_in % Q != 0:
            raise ConfigError(f"input length {n_in} must be a multiple of decim Q={Q}")
        n_blk = n_in // Q
        n_out = n_blk * P
        xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
        dt = torch.promote_types(xa.dtype, self.branches.dtype)
        j = np.arange(P)
        src_off = (j * Q) // P
        branch = (j * Q) % P
        if n_blk == 0:  # an empty block: no outputs, the window stands
            y = torch.zeros(x.shape[:-1] + (0,), dtype=dt, device=x.device)
        elif sched_matmul_ok(P, Q, L):
            y = sched_banded_matmul(xa, self.branches, src_off, branch, Q, n_blk)
        else:  # heavy decimation: the band matrix would be mostly zeros
            o = np.arange(n_out)
            src = torch.from_numpy(o // P * Q + src_off[o % P]).to(x.device)
            y = branch_dots(xa, self.branches, src, torch.from_numpy(branch[o % P]).to(x.device))
        return y * self.scale, self.replace(window=carry(self.window, xa))

    __call__ = execute_block
