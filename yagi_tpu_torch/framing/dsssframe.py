"""dsssframe64: direct-sequence spread-spectrum burst frame.

Port of :mod:`yagi_tpu.framing.dsssframe` (behavioral spec: liquid-dsp's
dsssframe64gen/dsssframe64sync, LIQUID_COMPAT.md:1037-1049): the frame64
format (protected 8-byte header + 64-byte payload, QPSK) with every data
symbol spread by a binary PN chip sequence, giving ~10·log10(sf) dB of
processing gain so frames decode well below 0 dB SNR. The wire format is
yagi_tpu's, sample for sample.

Where it runs: spreading (one outer product of symbols [S] and chips [sf]),
the pulse shaping, the derotation and FFT fractional delay, the matched
filter at the chip instants, the phase fit over the 256 preamble chips
and the despreading (one matmul of the [S, sf] chip matrix against
conj(pn)) on the object's device in complex128; the preamble fit takes the
chips' raw angles, so the carrier ramp is referenced at the burst
(:func:`._sync.derotate`; yagi_tpu's ``dsssframe.py:127`` references it at
the buffer's start and loses a frame whose residual phase sits at ±π).
After despreading, the blind 4th-power CFO estimate and the
decision-directed phase tracking are :mod:`._carrier`'s, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..modem.modem import Modem
from ..sequence.msequence import MSequence
from . import _sync
from ._carrier import dd_track, mth_power_cfo
from .frame64 import _K, _M, _pulse, _shape
from .qdetector import QDetector
from .qpacketmodem import QPacketModem

__all__ = ["DsssFrameGen64", "DsssFrameSync64"]

_HEADER_LEN = 8
_PAYLOAD_LEN = 64
_PRE_CHIPS = 256  # preamble chips


def _pn(n: int, m: int = 11) -> np.ndarray:
    ms = MSequence.create_default(m)
    bits = np.array([ms.advance() for _ in range(n)], dtype=np.float32)
    return (1.0 - 2.0 * bits).astype(np.complex64)


def _header_pm(device) -> QPacketModem:
    return QPacketModem(_HEADER_LEN, crc="crc32", fec0="golay2412", fec1="none",
                        mod_scheme="qpsk", device=device)


def _payload_pm(device) -> QPacketModem:
    return QPacketModem(_PAYLOAD_LEN, crc="crc32", fec0="hamming128", fec1="none",
                        mod_scheme="qpsk", device=device)


class _Dsss:
    """The geometry both ends share: spreading factor, codes, pulse."""

    def __init__(self, sf: int, device):
        if sf < 2 or sf > 256:
            raise ConfigError(f"spreading factor ({sf}) must be in [2,256]")
        self.device = resolve_device(device)
        self.sf = sf
        self.header_pm = _header_pm(self.device)
        self.payload_pm = _payload_pm(self.device)
        self.pn = torch.from_numpy(_pn(sf, m=7 if sf <= 64 else 11)).to(self.device)
        self.preamble = torch.from_numpy(_pn(_PRE_CHIPS, m=11)).to(self.device)
        self._h = torch.from_numpy(_pulse()).to(self.device)
        self._nsym = self.header_pm.get_frame_len() + self.payload_pm.get_frame_len()


class DsssFrameGen64(_Dsss):
    """DSSS burst frame generator (liquid ``dsssframe64gen``), on ``device``
    (the current CUDA device by default). ``sf`` is the spreading factor
    (chips/symbol)."""

    def __init__(self, sf: int = 8, device=None):
        super().__init__(sf, device)
        self.frame_len = (_PRE_CHIPS + self._nsym * sf + 2 * _M) * _K
        self._tail = torch.zeros(2 * _M, dtype=torch.complex64, device=self.device)

    def execute(self, header, payload) -> torch.Tensor:
        """header [8] bytes, payload [64] bytes -> samples [frame_len]
        (complex64, on the device)."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != _HEADER_LEN:
            raise ConfigError(f"header length {header.size} != {_HEADER_LEN}")
        if payload.size != _PAYLOAD_LEN:
            raise ConfigError(f"payload length {payload.size} != {_PAYLOAD_LEN}")
        syms = torch.cat([self.header_pm.encode(header), self.payload_pm.encode(payload)])
        # spread: one outer product [S, sf] -> chip stream
        chips = (syms[:, None] * self.pn[None, :]).reshape(-1)
        return _shape(torch.cat([self.preamble, chips, self._tail]), self._h)


class DsssFrameSync64(_Dsss):
    """DSSS burst frame synchronizer (liquid ``dsssframe64sync``), on
    ``device`` (the current CUDA device by default).

    ``execute(x)`` returns None or a dict like FrameSync64's."""

    def __init__(self, sf: int = 8, threshold: float = 0.35, dphi_max: float = 0.01,
                 n_dphi: int = 21, device=None):
        super().__init__(sf, device)
        self.detector = QDetector(_shape(self.preamble, self._h), threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi, device=self.device)
        self._qpsk = Modem.create("qpsk", device=self.device)

    def execute(self, x):
        """Search buffer ``x`` (a tensor or a numpy array); None or a dict."""
        x = _sync.as_samples(x, self.device)
        det = self.detector.detect(x)
        if det is None:
            return None
        y, i0 = _sync.derotate(x, det)
        nchip = _PRE_CHIPS + self._nsym * self.sf
        if i0 + _K * (nchip - 1) >= x.shape[0]:
            return None  # frame truncated by the buffer edge
        chips = _sync.matched_symbols(y, self._h, i0, _K, nchip)
        # residual carrier fit over the preamble chips
        a, b, amp = _sync.phase_fit(chips, self.preamble)
        chips = _sync.correct(chips, a, b, amp)
        # despread: [S, sf] @ conj(pn) / sf, the processing-gain matmul
        data = chips[_PRE_CHIPS:].reshape(self._nsym, self.sf)
        syms = (data @ self.pn.conj().to(torch.complex128)) / self.sf
        # despread symbols have a high post-gain SNR: strip the residual CFO
        # with a blind 4th-power estimate, then track the phase by decisions
        syms = syms.cpu().numpy()
        dphi_sym = mth_power_cfo(syms, m=4)
        syms = syms * np.exp(-1j * dphi_sym * np.arange(syms.size))
        syms = dd_track(syms, self._qpsk, chunk=32)
        hlen = self.header_pm.get_frame_len()
        header, hok = self.header_pm.decode_soft(syms[:hlen])
        payload, pok = self.payload_pm.decode_soft(syms[hlen:])
        err = chips[:_PRE_CHIPS] - self.preamble
        b, evm = torch.stack([b, 10.0 * torch.log10(err.abs().square().mean() + 1e-20)]).tolist()
        return {"header": header, "header_valid": bool(hok),
                "payload": payload, "payload_valid": bool(pok),
                "stats": {"rxy": det["rxy"], "tau": det["tau"], "dphi": det["dphi"] + b / _K,
                          "phi": det["phi"], "gamma": det["gamma"], "evm_db": float(evm)}}
