"""Symbol stream generators.

Port of :mod:`yagi_tpu.framing.symstream` (behavioral specs: the
reference's symstream.rs and symstreamr.rs):

* SymStream — random symbols from an m-sequence → Modem.modulate → ×gain →
  1:k interpolation (symstream.rs:104-121), a whole block of symbols at a
  time; a carry buffer preserves arbitrary block lengths.
* SymStreamR — SymStream at 2 samples/symbol followed by an arbitrary-rate
  MsResamp.

Where it runs: the m-sequence is host Python (exact LFSR), as in yagi_tpu;
the modem, the interpolator, the resampler and the sample carry are the
port's objects on the stream's device, and the samples come back as
complex64 tensors there. :func:`~yagi_tpu_torch._src.struct.load_into`
carries a yagi_tpu stream's state (modem, interpolator, resampler,
m-sequence register, carry) into one of these, to continue it sample for
sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..design import FirFilterShape
from ..filter import FirInterpolationFilter, MsResamp
from ..modem import Modem
from ..sequence import MSequence

__all__ = ["SymStream", "SymStreamR"]


class SymStream:
    """Symbol stream generator (symstream.rs:7-17), on ``device`` (the
    current CUDA device by default)."""

    def __init__(
        self,
        ftype: FirFilterShape = FirFilterShape.ARKAISER,
        k: int = 2,
        m: int = 7,
        beta: float = 0.3,
        scheme="qpsk",
        device=None,
    ):
        if k < 2:
            raise ConfigError("samples/symbol must be at least 2")
        if m == 0:
            raise ConfigError("filter delay must be greater than zero")
        if not 0.0 <= beta <= 1.0:
            raise ConfigError("filter excess bandwidth must be in (0,1]")
        self.device = resolve_device(device)
        self.ftype = ftype
        self.k = k
        self.m = m
        self.beta = beta
        self.modem = Modem.create(scheme, device=self.device)
        # m=11 randomizer (period 2047) per the reference's modem randomizer
        # (modem.rs:446); a shorter sequence's line spectrum notches the
        # signal PSD (visible as a ~3.6 dB DC dip at m=7)
        self.msequence = MSequence.create_default(11)
        self.gain = 1.0
        self.interp = FirInterpolationFilter.create_prototype(
            ftype, k, m, beta, 0.0, dtype=torch.complex64, device=self.device
        )
        self._carry = torch.zeros(0, dtype=torch.complex64, device=self.device)

    # ------------------------------------------------------------ properties
    def get_ftype(self):
        return self.ftype

    def get_k(self):
        return self.k

    def get_m(self):
        return self.m

    def get_beta(self):
        return self.beta

    def get_scheme(self):
        return self.modem.get_scheme()

    def set_scheme(self, scheme) -> None:
        self.modem = Modem.create(scheme, device=self.device)

    def set_gain(self, gain: float) -> None:
        self.gain = gain

    def get_gain(self) -> float:
        return self.gain

    def get_delay(self) -> int:
        """k·m samples (symstream.rs:100-102)."""
        return self.k * self.m

    def reset(self) -> None:
        self.modem = self.modem.reset()
        self.interp = self.interp.reset()
        self.msequence.reset()
        self._carry = self._carry[:0]

    # -------------------------------------------------------------- generate
    def write_samples(self, num_samples: int) -> torch.Tensor:
        """Generate num_samples samples (symstream.rs:111-121), complex64 on
        the device."""
        need = num_samples - self._carry.shape[0]
        if need > 0:
            n_sym = -(-need // self.k)
            syms = self.msequence.generate_symbols(
                self.modem.bits_per_symbol, n_sym
            )
            v, self.modem = self.modem.modulate(syms)
            v = v * float(np.float32(self.gain))
            block, self.interp = self.interp.execute_block(v)
            self._carry = torch.cat([self._carry, block])
        out = self._carry[:num_samples]
        self._carry = self._carry[num_samples:]
        return out


class SymStreamR:
    """Arbitrary-rate symbol stream = SymStream + MsResamp
    (symstreamr.rs:10-16), on ``device`` (the current CUDA device by
    default)."""

    def __init__(
        self,
        ftype: FirFilterShape = FirFilterShape.ARKAISER,
        bw: float = 0.5,
        m: int = 7,
        beta: float = 0.3,
        scheme="qpsk",
        device=None,
    ):
        if bw <= 0.0 or bw > 1.0:
            raise ConfigError("bandwidth must be in (0,1)")
        self.bw = bw
        # internal symstream at k=2 samples/symbol, resampled by 0.5/bw
        # (symstreamr.rs:36-38); get_bw = 1/(rate·k)
        self.symstream = SymStream(ftype, 2, m, beta, scheme, device=device)
        self.device = self.symstream.device
        self.resamp = MsResamp.create(0.5 / bw, 60.0, device=self.device)
        self._carry = torch.zeros(0, dtype=torch.complex64, device=self.device)

    def get_bw(self) -> float:
        return self.bw

    def get_ftype(self):
        return self.symstream.get_ftype()

    def get_m(self):
        return self.symstream.get_m()

    def get_beta(self):
        return self.symstream.get_beta()

    def get_scheme(self):
        return self.symstream.get_scheme()

    def set_scheme(self, scheme) -> None:
        self.symstream.set_scheme(scheme)

    def set_gain(self, gain: float) -> None:
        self.symstream.set_gain(gain)

    def get_gain(self) -> float:
        return self.symstream.get_gain()

    def get_bw_actual(self) -> float:
        return 1.0 / (self.resamp.get_rate() * self.symstream.get_k())

    def get_delay(self) -> float:
        """(p + d)·r (symstreamr.rs:94-99)."""
        p = float(self.symstream.get_delay())
        d = float(self.resamp.get_delay())
        r = float(self.resamp.get_rate())
        return (p + d) * r

    def reset(self) -> None:
        self.symstream.reset()
        self.resamp = self.resamp.reset()
        self._carry = self._carry[:0]

    def write_samples(self, num_samples: int) -> torch.Tensor:
        """Generate num_samples samples (symstreamr.rs:118ff), complex64 on
        the device.

        Generated in power-of-two input chunks sized to the request (one
        resampler call per chunk) rather than the reference's fixed tiny
        buffer loop; the chunking decides where a ``set_gain`` lands, so it
        is yagi_tpu's.
        """
        parts = [self._carry]
        have = self._carry.shape[0]
        rate = float(self.resamp.get_rate())
        while have < num_samples:
            # size the input chunk to the remaining request: large requests
            # amortize, small requests stay input-sample granular so
            # set_gain takes effect within ~1 input sample of carried
            # lookahead — the reference's buffer holds at most one input
            # sample's worth of resampler output (symstreamr.rs:40-48)
            need_in = max(1, int(np.ceil((num_samples - have) / max(rate, 1e-6))))
            chunk_in = 1
            while chunk_in < need_in and chunk_in < (1 << 16):
                chunk_in *= 2
            x = self.symstream.write_samples(chunk_in)
            y, self.resamp = self.resamp.execute(x)
            y = y.reshape(-1)
            parts.append(y)
            have += y.shape[0]
        self._carry = torch.cat(parts) if len(parts) > 1 else parts[0]
        out = self._carry[:num_samples]
        self._carry = self._carry[num_samples:]
        return out
