"""msource: multi-signal source generator.

Port of :mod:`yagi_tpu.framing.msource` (behavioral spec: liquid-dsp's
msource): a container of independent signal sources — tones, band-limited
noise, linear FM chirps and modulated symbol streams — each placed at its
own center frequency with its own gain, summed into one output stream.
Used to build test spectra for channelizer and receiver validation.

Where it runs: on the object's device, every source makes a block at
baseband (a tone of ones; noise filtered by a Kaiser lowpass as one
float64 banded matmul with its carried tail; a chirp's float64 phase; the
port's :class:`~.symstream.SymStreamR`), and the shift to its center
frequency is a float64 mixer with an exact per-source phase carry (a host
float, kept mod 2π), so repeated ``write_samples`` calls are block-size
invariant. The noise is drawn on the host from ``np.random.default_rng(seed)``,
in yagi_tpu's order, so the port's noise equals yagi_tpu's sample for
sample; ``write_samples`` returns a complex64 tensor on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src.device import resolve_device
from ..design.fir import fir_design_kaiser
from ..errors import ConfigError
from ..filter._conv import causal_conv_valid
from .symstream import SymStreamR

__all__ = ["MSource"]


class _Source:
    def __init__(self, fc: float, gain_db: float, device):
        if not -0.5 <= fc <= 0.5:
            raise ConfigError(f"center frequency fc ({fc}) not in [-0.5,0.5]")
        self.fc = fc
        self.gain = 10.0 ** (gain_db / 20.0)
        self.enabled = True
        self.device = device
        self._phase = 0.0

    def _mix(self, base: torch.Tensor) -> torch.Tensor:
        n = torch.arange(base.shape[0], dtype=torch.float64, device=self.device)
        ph = 2 * math.pi * self.fc * n + self._phase
        out = base.to(torch.complex128) * torch.polar(torch.ones_like(ph), ph)
        self._phase = float((self._phase + 2 * np.pi * self.fc * base.shape[0]) % (2 * np.pi))
        return (self.gain * out).to(torch.complex64)


class _Tone(_Source):
    def baseband(self, n: int, rng) -> torch.Tensor:
        return torch.ones(n, dtype=torch.complex64, device=self.device)


class _Noise(_Source):
    def __init__(self, fc: float, bw: float, gain_db: float, device):
        super().__init__(fc, gain_db, device)
        if not 0.0 < bw <= 1.0:
            raise ConfigError(f"noise bandwidth ({bw}) not in (0,1]")
        self.bw = bw
        if bw < 0.995:
            h_len = 4 * int(np.ceil(2.0 / bw)) * 2 + 1
            h = fir_design_kaiser(h_len, bw / 2, 60.0, 0.0)
            self._h = torch.from_numpy(h / np.sqrt(np.sum(h ** 2))).to(device)
            self._tail = torch.zeros(h_len - 1, dtype=torch.complex128, device=device)
        else:
            self._h = None

    def baseband(self, n: int, rng) -> torch.Tensor:
        re, im = rng.normal(size=n), rng.normal(size=n)
        # complex64 draws scaled in complex128, as yagi_tpu's numpy does
        w = torch.complex(torch.from_numpy(re).to(torch.float32),
                          torch.from_numpy(im).to(torch.float32)).to(
            self.device, torch.complex128) / np.sqrt(2)
        if self._h is None:
            return w
        seq = torch.cat([self._tail, w])
        self._tail = seq[seq.shape[0] - self._tail.shape[0]:]
        return causal_conv_valid(seq, self._h)


class _Chirp(_Source):
    """Linear FM sweep across ``bw`` over ``duration`` samples
    (liquid msource_crcf_add_chirp; msourcecf_chirp autotest)."""

    def __init__(self, fc: float, bw: float, gain_db: float, duration: float, negate: bool,
                 repeat: bool, device):
        super().__init__(fc, gain_db, device)
        if not 0.0 < bw <= 1.0:
            raise ConfigError(f"chirp bandwidth ({bw}) not in (0,1]")
        if duration < 1:
            raise ConfigError(f"chirp duration ({duration}) must be >= 1")
        self.bw = float(bw)
        self.duration = float(duration)
        self.negate = bool(negate)
        self.repeat = bool(repeat)
        self._t = 0.0

    def baseband(self, n: int, rng) -> torch.Tensor:
        t = self._t + torch.arange(n, dtype=torch.float64, device=self.device)
        # fmod is exact, and equals numpy's mod for t ≥ 0
        tt = torch.fmod(t, self.duration) if self.repeat else torch.clamp(t, max=self.duration)
        # instantaneous frequency sweeps -bw/2 -> +bw/2; phase is its integral
        sgn = -1.0 if self.negate else 1.0
        phase = 2 * math.pi * sgn * self.bw * (tt * tt / (2 * self.duration) - tt / 2)
        self._t += n
        return torch.polar(torch.ones_like(phase), phase).to(torch.complex64)


class _ModemSrc(_Source):
    def __init__(self, fc: float, bw: float, gain_db: float, scheme: str, m: int, beta: float,
                 device):
        super().__init__(fc, gain_db, device)
        self.stream = SymStreamR(bw=bw, m=m, beta=beta, scheme=scheme, device=device)

    def baseband(self, n: int, rng) -> torch.Tensor:
        return self.stream.write_samples(n)


class MSource:
    """Multi-source signal generator (liquid ``msource``), on ``device``
    (the current CUDA device by default); the noise sources draw from
    ``np.random.default_rng(seed)`` on the host."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._sources: dict[int, _Source] = {}
        self._next_id = 0
        self._rng = np.random.default_rng(seed)

    def _add(self, src: _Source) -> int:
        sid = self._next_id
        self._sources[sid] = src
        self._next_id += 1
        return sid

    def add_tone(self, fc: float, gain_db: float = 0.0) -> int:
        """Complex tone at fc (liquid ``msource_add_tone``)."""
        return self._add(_Tone(fc, gain_db, self.device))

    def add_noise(self, fc: float, bw: float, gain_db: float = 0.0) -> int:
        """Band-limited Gaussian noise (liquid ``msource_add_noise``)."""
        return self._add(_Noise(fc, bw, gain_db, self.device))

    def add_chirp(self, fc: float, bw: float, gain_db: float = 0.0, duration: float = 1000.0,
                  negate: bool = False, repeat: bool = True) -> int:
        """Linear FM chirp sweeping bw over duration samples
        (liquid ``msource_add_chirp``)."""
        return self._add(_Chirp(fc, bw, gain_db, duration, negate, repeat, self.device))

    def add_modem(self, scheme: str, fc: float, bw: float, gain_db: float = 0.0, m: int = 7,
                  beta: float = 0.3) -> int:
        """Modulated symbol stream (liquid ``msource_add_modem``)."""
        return self._add(_ModemSrc(fc, bw, gain_db, scheme, m, beta, self.device))

    def remove(self, sid: int) -> None:
        if sid not in self._sources:
            raise ConfigError(f"unknown source id {sid}")
        del self._sources[sid]

    def enable(self, sid: int) -> None:
        self._sources[sid].enabled = True

    def disable(self, sid: int) -> None:
        self._sources[sid].enabled = False

    def get_num_sources(self) -> int:
        return len(self._sources)

    def write_samples(self, n: int) -> torch.Tensor:
        """Sum of all enabled sources, n samples (block-size invariant),
        complex64 on the device."""
        out = torch.zeros(n, dtype=torch.complex64, device=self.device)
        for src in self._sources.values():
            mixed = src._mix(src.baseband(n, self._rng))  # a muted source keeps advancing
            if src.enabled:
                out += mixed
        return out
