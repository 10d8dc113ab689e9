"""Analog amplitude modulator / demodulator (AM: DSB, USB, LSB).

Port of :mod:`yagi_tpu.modem.ampmodem` (liquid-dsp's ``ampmodem``):
modulation index ``mu`` > 0, sideband type DSB, USB or LSB, carrier
suppressed or not.

- modulate (real message m[n] ∈ [-1, 1] → complex baseband y[n]): the
  message (DSB) or its analytic extension (SSB: a streaming length-(4m+1)
  Kaiser-windowed type-III FIR Hilbert transformer, the in-phase arm
  delayed by 2m samples) scaled by ``mu``; with a carrier, a unit DC term
  is added and the sum scaled by 1/(1 + mu).
- demodulate: with a carrier, a one-pole tracker c[k] = (1−α)·c[k−1] +
  α·y[k] extracts the DC pilot, then the samples are derotated and
  envelope-detected (DSB) or their real part taken (SSB); a suppressed
  carrier demodulates coherently as Re(y)/mu.

The tracker is the first-order all-pole recurrence of the IIR kernels: it
runs as one ``iir_chunked`` launch per block on the card
(:func:`~yagi_tpu_torch.kernels.iir.iir_chunked_apply` with b = [1, 0],
a = [1, −(1 − α)] over α·y, the carried ``carrier`` as the state) and as
its plain version, the log-depth ``allpole_parallel``, on the CPU; yagi_tpu
evaluates the same recurrence with ``associative_scan``.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..filter.firfilt import FirFilter
from ..kernels.iir import chunked_fits, iir_chunked_apply
from ..math.windows import kaiser as _kaiser_window

__all__ = ["AmpModemType", "AmpModem"]


class AmpModemType(enum.Enum):
    DSB = "dsb"
    USB = "usb"
    LSB = "lsb"


def _hilbert_taps(m: int, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed odd-length type-III Hilbert transformer, n = 4m + 1:
    h[k] = 2/(πk) for odd k, 0 for even k (antisymmetric)."""
    n = 4 * m + 1
    k = np.arange(n) - (n - 1) // 2
    h = np.zeros(n, dtype=np.float64)
    odd = (k % 2) != 0
    h[odd] = 2.0 / (np.pi * k[odd])
    w = np.asarray(_kaiser_window(n, beta))
    return (h * w).astype(np.float32)


def _carrier_track(y: torch.Tensor, carrier: torch.Tensor, alpha: float):
    """c[k] = (1−α)·c[k−1] + α·y[k] over the block y [..., N] (complex64),
    starting from ``carrier`` [...]: one ``iir_chunked`` launch on the card,
    its plain version on the CPU. Returns (c [..., N], the last c)."""
    if not chunked_fits(1, 1, True, False):
        raise RuntimeError("iir_chunked does not take the first-order carrier tracker")
    batch = y.shape[:-1]
    x = (y * float(np.float32(alpha))).reshape(math.prod(batch), y.shape[-1]).contiguous()
    f32 = dict(dtype=torch.float32, device=y.device)
    b = torch.tensor([1.0, 0.0], **f32)
    a = torch.tensor([1.0, -float(np.float32(1.0 - alpha))], **f32)
    v = carrier.reshape(-1, 1).to(torch.complex64).contiguous()
    c, v_new = iir_chunked_apply(x, b, a, torch.tensor(1.0, **f32), v, sos=False)
    return c.reshape(y.shape), v_new.reshape(batch)


@struct.state
class AmpModem:
    """AM modulator/demodulator state (liquid ampmodem)."""

    mu: float = struct.static_field()
    type: AmpModemType = struct.static_field()
    suppressed: bool = struct.static_field()
    m: int = struct.static_field()  # Hilbert semi-length (SSB only)
    alpha: float = struct.static_field()  # carrier-tracker pole
    hilb: FirFilter | None = struct.field()  # quadrature arm (SSB)
    delay_line: torch.Tensor | None = struct.field()  # in-phase delay (SSB)
    carrier: torch.Tensor = struct.field()  # one-pole carrier estimate (demod)

    def __post_init__(self):
        # a type carried over from yagi_tpu (load_state) is its own enum
        if not isinstance(self.type, AmpModemType):
            object.__setattr__(self, "type", AmpModemType(self.type.value))

    @classmethod
    def create(
        cls,
        mu: float = 0.1,
        type: AmpModemType | str = AmpModemType.DSB,
        suppressed: bool = False,
        m: int = 25,
        carrier_bw: float = 0.01,
        batch_shape: tuple = (),
        device=None,
    ) -> "AmpModem":
        device = resolve_device(device)
        if mu <= 0.0:
            raise ConfigError(f"modulation index {mu:.4e} must be greater than 0")
        if isinstance(type, str):
            type = AmpModemType(type.lower())
        if m < 1:
            raise ConfigError(f"Hilbert semi-length {m} must be at least 1")
        if not 0.0 < carrier_bw < 0.5:
            raise ConfigError(f"carrier bandwidth {carrier_bw:.4e} must be in (0, 0.5)")
        ssb = type is not AmpModemType.DSB
        hilb = (FirFilter.create(_hilbert_taps(m), batch_shape=batch_shape, dtype=torch.float32,
                                 device=device) if ssb else None)
        delay = (torch.zeros(batch_shape + (2 * m,), dtype=torch.float32, device=device)
                 if ssb else None)
        return cls(
            mu=float(mu), type=type, suppressed=bool(suppressed), m=int(m),
            alpha=float(carrier_bw), hilb=hilb, delay_line=delay,
            carrier=torch.ones(batch_shape, dtype=torch.complex64, device=device),
        )

    @property
    def delay(self) -> int:
        """Message → demodulator group delay in samples (0 for DSB)."""
        return 0 if self.type is AmpModemType.DSB else 2 * self.m

    def reset(self) -> "AmpModem":
        return self.replace(
            hilb=self.hilb.reset() if self.hilb is not None else None,
            delay_line=(torch.zeros_like(self.delay_line)
                        if self.delay_line is not None else None),
            carrier=torch.ones_like(self.carrier),
        )

    def _analytic(self, x: torch.Tensor) -> tuple[torch.Tensor, "AmpModem"]:
        """Streaming analytic extension: x (delayed 2m) + j·H{x}."""
        xq, hilb = self.hilb.execute_block(x)
        full = torch.cat([self.delay_line, x], -1)
        n = x.shape[-1]
        s = torch.complex(full[..., :n], xq)
        return s, self.replace(hilb=hilb, delay_line=full[..., n:])

    def modulate(self, x) -> tuple[torch.Tensor, "AmpModem"]:
        """Modulate a real message block x [..., N] → complex64 baseband."""
        x = torch.as_tensor(x, device=self.carrier.device).to(torch.float32)
        new = self
        if self.type is AmpModemType.DSB:
            s = x.to(torch.complex64)
        else:
            s, new = self._analytic(x)
            if self.type is AmpModemType.LSB:
                s = s.conj().resolve_conj()
        s = float(np.float32(self.mu)) * s
        if not self.suppressed:
            s = (1.0 + s) * float(np.float32(1.0 / (1.0 + self.mu)))
        return s.to(torch.complex64), new

    modulate_block = modulate

    def demodulate(self, y) -> tuple[torch.Tensor, "AmpModem"]:
        """Demodulate complex baseband y [..., N] → float32 message."""
        y = torch.as_tensor(y, device=self.carrier.device).to(torch.complex64)
        inv_mu = float(np.float32(1.0 / self.mu))
        if self.suppressed:
            return y.real * inv_mu, self
        c, carrier = _carrier_track(y, self.carrier, self.alpha)
        phase = torch.polar(torch.ones_like(c.real), -torch.angle(c))
        yd = y * phase * float(np.float32(1.0 + self.mu))
        if self.type is AmpModemType.DSB:
            m = (yd.abs() - 1.0) * inv_mu
        else:
            m = (yd.real - 1.0) * inv_mu
        return m.to(torch.float32), self.replace(carrier=carrier)

    demodulate_block = demodulate
