"""Farrow fractional-delay filter, streaming autocorrelator, DDS.

Port of :mod:`yagi_tpu.filter.farrow` (liquid-dsp's firfarrow, autocorr and
dds; the reference's files are empty stubs):

* FirFarrow: fractional delay by per-tap polynomials in μ, fitted on the
  host over a grid of Kaiser windowed-sinc designs h(μ), so
  h_i(μ) = Σ_k c[i,k]·μ^k gives any delay in [-0.5, 0.5] without a new
  design;
* AutoCorr: windowed autocorrelation rxx[n] = Σ_w x[n-w]·conj(x[n-w-d]), a
  one-lag product stream through a moving-sum window;
* Dds: direct digital synthesizer up/down converter, a mix by ±fc and a
  2^k halfband cascade.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from .. import design
from ..math.poly import poly_fit
from ..nco.osc import Osc
from ._conv import causal_conv_valid
from .msresamp2 import MsResamp2

__all__ = ["FirFarrow", "AutoCorr", "Dds"]


@struct.state
class FirFarrow:
    """Farrow-structure fractional delay."""

    h_len: int = struct.static_field()
    order: int = struct.static_field()
    coeffs: torch.Tensor = struct.field()  # [h_len, order+1] per-tap μ-polynomials
    mu: torch.Tensor = struct.field()
    window: torch.Tensor = struct.field()  # [..., h_len] conv history

    @classmethod
    def create(cls, h_len: int = 17, order: int = 3, fc: float = 0.45, as_: float = 60.0,
               batch_shape: tuple = (), dtype=torch.complex64, device=None) -> "FirFarrow":
        device = resolve_device(device)
        if h_len == 0:
            raise ConfigError("filter length must be greater than zero")
        if order == 0:
            raise ConfigError("polynomial order must be greater than zero")
        # per-tap polynomials fitted over a μ grid of exact Kaiser designs,
        # scaled by 2·fc for unit passband gain
        mus = np.linspace(-0.499, 0.499, 4 * (order + 1))
        H = np.stack([design.fir_design_kaiser(h_len, fc, as_, float(mu)) * (2.0 * fc)
                      for mu in mus])  # [n_mu, h_len]
        coeffs = np.stack([poly_fit(mus, H[:, i], order + 1) for i in range(h_len)])
        return cls(
            h_len=h_len,
            order=order,
            coeffs=torch.from_numpy(coeffs.astype(np.float32)).to(device),
            mu=torch.tensor(0.0, dtype=torch.float32, device=device),
            window=torch.zeros(batch_shape + (h_len,), dtype=dtype, device=device),
        )

    def set_delay(self, mu) -> "FirFarrow":
        """Fractional DELAY μ ∈ [-0.5, 0.5] around the center (n-1)/2. The
        Kaiser design's offset advances the impulse, so the stored
        polynomial variable is -μ."""
        if isinstance(mu, (int, float)) and not -0.5 <= mu <= 0.5:
            raise ConfigError("delay must be in [-0.5, 0.5]")
        return self.replace(mu=-torch.as_tensor(mu, dtype=torch.float32, device=self.mu.device))

    def get_delay(self):
        return -self.mu

    def taps(self) -> torch.Tensor:
        """The current taps h(μ), by Horner's rule."""
        h = self.coeffs[:, -1]
        for k in range(self.order - 1, -1, -1):
            h = h * self.mu + self.coeffs[:, k]
        return h

    def reset(self) -> "FirFarrow":
        return self.replace(window=torch.zeros_like(self.window))

    def execute_block(self, x) -> tuple[torch.Tensor, "FirFarrow"]:
        x = torch.as_tensor(x, device=self.window.device)
        xa = torch.cat([self.window[..., 1:].to(x.dtype), x], dim=-1)
        return causal_conv_valid(xa, self.taps()), self.replace(window=carry(self.window, xa))

    __call__ = execute_block

    def groupdelay(self, fc: float) -> float:
        return design.fir_group_delay(self.taps().cpu().numpy(), fc)


@struct.state
class AutoCorr:
    """Streaming windowed autocorrelator:
    rxx[n] = Σ_{w=0..W-1} x[n-w] · conj(x[n-w-delay])."""

    window_size: int = struct.static_field()
    delay: int = struct.static_field()
    hist: torch.Tensor = struct.field()  # [..., W+delay-1] raw history

    @classmethod
    def create(cls, window_size: int, delay: int, batch_shape: tuple = (),
               dtype=torch.complex64, device=None) -> "AutoCorr":
        device = resolve_device(device)
        if window_size == 0:
            raise ConfigError("window size must be greater than zero")
        return cls(
            window_size=window_size,
            delay=delay,
            hist=torch.zeros(batch_shape + (window_size + delay - 1,), dtype=dtype,
                             device=device),
        )

    def reset(self) -> "AutoCorr":
        return self.replace(hist=torch.zeros_like(self.hist))

    def execute_block(self, x) -> tuple[torch.Tensor, "AutoCorr"]:
        x = torch.as_tensor(x, device=self.hist.device)
        W, d = self.window_size, self.delay
        xa = torch.cat([self.hist.to(x.dtype), x], dim=-1)
        # p[n] = x[n]·conj(x[n − d]), its last entry the newest
        prod = xa[..., d:] * torch.conj(xa[..., : xa.shape[-1] - d])
        ones = torch.ones(W, dtype=torch.float32, device=x.device)
        rxx = causal_conv_valid(prod, ones)
        return rxx[..., rxx.shape[-1] - x.shape[-1] :], self.replace(hist=carry(self.hist, xa))

    __call__ = execute_block


@struct.state
class Dds:
    """Direct digital synthesizer up/down converter.

    decim: mix down by fc → 2^k halfband decimation cascade.
    interp: 2^k halfband interpolation cascade → mix up by fc.
    """

    num_stages: int = struct.static_field()
    fc: float = struct.static_field()
    osc_down: Osc = struct.field()
    osc_up: Osc = struct.field()
    decim_cascade: MsResamp2 = struct.field()
    interp_cascade: MsResamp2 = struct.field()

    @classmethod
    def create(cls, num_stages: int, fc: float, bw: float = 0.4, as_: float = 60.0,
               batch_shape: tuple = (), device=None) -> "Dds":
        device = resolve_device(device)
        if num_stages > 16:
            raise ConfigError("number of stages should not exceed 16")
        if not -0.5 <= fc <= 0.5:
            raise ConfigError("center frequency must be in [-0.5, 0.5]")

        def osc():
            return Osc.create("exact", batch_shape=batch_shape, device=device).set_frequency(
                2.0 * np.pi * fc)

        return cls(
            num_stages=num_stages,
            fc=float(fc),
            osc_down=osc(),
            osc_up=osc(),
            decim_cascade=MsResamp2.create(False, num_stages, bw, 0.0, as_,
                                           batch_shape=batch_shape, device=device),
            interp_cascade=MsResamp2.create(True, num_stages, bw, 0.0, as_,
                                            batch_shape=batch_shape, device=device),
        )

    def reset(self) -> "Dds":
        return self.replace(
            osc_down=self.osc_down.reset().set_frequency(2.0 * np.pi * self.fc),
            osc_up=self.osc_up.reset().set_frequency(2.0 * np.pi * self.fc),
            decim_cascade=self.decim_cascade.reset(),
            interp_cascade=self.interp_cascade.reset(),
        )

    def decim_execute(self, x) -> tuple[torch.Tensor, "Dds"]:
        """High-rate x [..., N·2^k] → baseband [..., N]."""
        x = torch.as_tensor(x, device=self.osc_down.theta.device)
        mixed, osc = self.osc_down.mix_block_down(x)
        y, cas = self.decim_cascade.execute_block(mixed)
        return y, self.replace(osc_down=osc, decim_cascade=cas)

    def interp_execute(self, x) -> tuple[torch.Tensor, "Dds"]:
        """Baseband x [..., N] → high-rate [..., N·2^k] at +fc."""
        x = torch.as_tensor(x, device=self.osc_up.theta.device)
        y, cas = self.interp_cascade.execute_block(x)
        mixed, osc = self.osc_up.mix_block_up(y)
        return mixed, self.replace(osc_up=osc, interp_cascade=cas)
