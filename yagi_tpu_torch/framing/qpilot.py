"""qpilotgen / qpilotsync: pilot-assisted carrier recovery for packets.

Port of :mod:`yagi_tpu.framing.qpilot` (behavioral spec: liquid-dsp,
LIQUID_COMPAT.md:1188-1197): the generator interleaves known QPSK pilot
symbols (from an m-sequence) every ``pilot_spacing`` positions into a
payload symbol stream; the synchronizer estimates channel gain, carrier
frequency offset, and carrier phase from the received pilots and corrects
the payload.

The CFO estimate is one zero-padded FFT over the pilot correlation sequence
(argmax + quadratic interpolation for sub-bin resolution); gain/phase are
weighted reductions; the payload correction is a single vector rotate.

Where it runs: the pilot sequence and index maps are built on the host once
(the m-sequence is host Python, as in yagi_tpu). On the object's device:
the frame assembly, the FFT (complex64, yagi_tpu's ``jnp.fft``), its peak,
and the correction in complex128 (yagi_tpu's numpy). Two host reads a
frame: the peak bin with its neighbours, then the stats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..sequence.msequence import MSequence
from ._sync import as_samples

__all__ = ["QPilotGen", "QPilotSync"]


def _pilot_layout(payload_len: int, pilot_spacing: int):
    """Number of pilots and frame length (liquid qpilotgen_create)."""
    div = pilot_spacing - 1
    num_pilots = (payload_len + div - 1) // div
    return num_pilots, payload_len + num_pilots


def _pilot_sequence(num_pilots: int) -> np.ndarray:
    """QPSK pilots from a default m-sequence (liquid's generator)."""
    ms = MSequence.create_default(7)
    sym = np.empty(num_pilots, dtype=np.complex64)
    s22 = np.float32(np.sqrt(0.5))
    for i in range(num_pilots):
        b0 = ms.advance()
        b1 = ms.advance()
        sym[i] = ((1.0 - 2.0 * b0) + 1j * (1.0 - 2.0 * b1)) * s22
    return sym


class _Pilots:
    """The pilot layout shared by the generator and the synchronizer."""

    def __init__(self, payload_len: int, pilot_spacing: int, device):
        if payload_len < 1:
            raise ConfigError(f"payload length ({payload_len}) must be >= 1")
        if pilot_spacing < 2:
            raise ConfigError(
                f"pilot spacing ({pilot_spacing}) must be >= 2")
        self.device = resolve_device(device)
        self.payload_len = payload_len
        self.pilot_spacing = pilot_spacing
        self.num_pilots, self.frame_len = _pilot_layout(
            payload_len, pilot_spacing)
        self.pilots = torch.from_numpy(_pilot_sequence(self.num_pilots)).to(self.device)
        # index maps, computed once
        pilot_idx = np.arange(self.num_pilots) * pilot_spacing
        mask = np.zeros(self.frame_len, dtype=bool)
        mask[pilot_idx] = True
        self._pilot_idx = torch.from_numpy(pilot_idx).to(self.device)
        self._payload_idx = torch.from_numpy(np.nonzero(~mask)[0]).to(self.device)

    def get_frame_len(self) -> int:
        return self.frame_len

    def _frame(self, x, n: int, what: str) -> torch.Tensor:
        x = as_samples(x, self.device)
        if x.shape[0] != n:
            raise ConfigError(f"{what} length {x.shape[0]} != {n}")
        return x


class QPilotGen(_Pilots):
    """Insert pilot symbols into a payload symbol stream, on ``device``
    (the current CUDA device by default)."""

    def __init__(self, payload_len: int, pilot_spacing: int, device=None):
        super().__init__(payload_len, pilot_spacing, device)

    def execute(self, payload) -> torch.Tensor:
        """payload symbols [payload_len] -> frame [frame_len] (complex64, on
        the device)."""
        payload = self._frame(payload, self.payload_len, "payload")
        frame = torch.empty(self.frame_len, dtype=torch.complex64, device=self.device)
        frame[self._pilot_idx] = self.pilots
        frame[self._payload_idx] = payload
        return frame


class QPilotSync(_Pilots):
    """Recover gain/CFO/phase from pilots and correct the payload, on
    ``device`` (the current CUDA device by default).

    ``execute(frame)`` returns ``(payload, info)`` with info keys
    ``dphi`` (rad/symbol), ``phi``, ``gain``, ``evm`` (pilot rms error).
    """

    def __init__(self, payload_len: int, pilot_spacing: int,
                 nfft_factor: int = 16, device=None):
        super().__init__(payload_len, pilot_spacing, device)
        self.nfft = max(64, int(2 ** np.ceil(
            np.log2(self.num_pilots * nfft_factor))))

    def execute(self, frame):
        frame = self._frame(frame, self.frame_len, "frame")
        rx_pilots = frame[self._pilot_idx]
        # de-rotate by the known pilots: v[i] = gain * exp(j(dphi*i*G + phi))
        v = rx_pilots * self.pilots.conj()
        V = torch.fft.fft(v, self.nfft).abs()
        i0 = torch.argmax(V)
        near = V[torch.stack([i0 - 1, i0, i0 + 1]) % self.nfft]
        i0, ym1, y0, yp1 = torch.cat([i0.reshape(1).to(torch.float64),
                                      near.to(torch.float64)]).tolist()  # host read
        i0 = int(i0)
        ym1, y0, yp1 = np.float32(ym1), np.float32(y0), np.float32(yp1)
        # quadratic interpolation around the peak (sub-bin CFO)
        denom = ym1 - 2.0 * y0 + yp1
        d = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
        d = float(np.clip(d, -0.5, 0.5))
        bin_f = i0 + d
        if bin_f > self.nfft / 2:
            bin_f -= self.nfft
        # frequency per *pilot index*, convert to per frame symbol
        dphi = 2.0 * math.pi * bin_f / (self.nfft * self.pilot_spacing)
        # remove CFO then estimate phase + gain from the coherent sum
        n_pil = self._pilot_idx.to(torch.float64)
        s = (v * torch.polar(torch.ones_like(n_pil), -dphi * n_pil)).sum()
        phi = torch.angle(s)
        gain = (s.abs() / self.pilots.abs().square().sum().to(torch.float64)).clamp(min=1e-9)
        # correct the whole frame
        n = torch.arange(self.frame_len, dtype=torch.float64, device=self.device)
        corr = frame * torch.polar(torch.ones_like(n), -(dphi * n + phi)) / gain
        payload = corr[self._payload_idx].to(torch.complex64)
        evm = (corr[self._pilot_idx] - self.pilots).abs().square().mean().sqrt()
        phi, gain, evm = torch.stack([phi, gain, evm]).tolist()  # host read
        return payload, {"dphi": float(dphi), "phi": phi, "gain": gain,
                         "evm": evm}
