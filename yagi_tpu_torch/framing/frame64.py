"""frame64: fixed-configuration burst frame generator + synchronizer.

Port of :mod:`yagi_tpu.framing.frame64` (behavioral spec: liquid-dsp's
frame64, ``framegen64``/``framesync64`` rows in LIQUID_COMPAT.md:1009-1283):
a fixed burst format with a 64-symbol BPSK p/n preamble, a protected 8-byte
header, a protected 64-byte payload, root-Nyquist pulse shaping at k=2
samples/symbol, and a synchronizer that recovers timing (sub-sample),
carrier frequency/phase, and gain from a raw sample buffer, then decodes
header and payload with CRC validation. The wire format is yagi_tpu's,
sample for sample.

Where it runs: the pulse and the preamble are made on the host once (numpy
design math and the m-sequence, as yagi_tpu). The generator's pulse shaping
(yagi_tpu's ``_shape``, ``frame64.py:85-90``) and the synchronizer's
derotation, FFT fractional delay, matched filter and weighted phase fit
(``:138-195``) run on the object's device in complex128 (:mod:`._sync`), and
return complex64. Host reads a frame: the detection's peak, the decoded
bits of the header and of the payload, and the stats.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..design import fir as fir_design
from ..sequence.msequence import MSequence
from . import _sync
from .qdetector import QDetector
from .qpacketmodem import QPacketModem, _frame_len

__all__ = ["FrameGen64", "FrameSync64", "FRAME64_LEN"]

_K = 2          # samples/symbol
_M = 7          # pulse semi-length in symbols
_BETA = 0.3     # excess bandwidth
_BPS = 2        # QPSK, the header's and the payload's modulation


def _pulse() -> np.ndarray:
    h = fir_design.fir_design_arkaiser(_K, _M, _BETA, 0.0)
    return (h / np.sqrt(np.sum(h * h) * _K)).astype(np.float32)


def _preamble_symbols() -> np.ndarray:
    ms = MSequence.create_default(7)
    bits = np.array([ms.advance() for _ in range(64)], dtype=np.float32)
    return (1.0 - 2.0 * bits).astype(np.complex64)  # BPSK +/-1


_HEADER_LEN = 8
_PAYLOAD_LEN = 64
_HEADER = dict(crc="crc32", fec0="golay2412", fec1="none")
_PAYLOAD = dict(crc="crc32", fec0="hamming128", fec1="conv27p23")


def _header_pm(device) -> QPacketModem:
    return QPacketModem(_HEADER_LEN, **_HEADER, mod_scheme="qpsk", device=device)


def _payload_pm(device) -> QPacketModem:
    return QPacketModem(_PAYLOAD_LEN, **_PAYLOAD, mod_scheme="qpsk", device=device)


@functools.lru_cache(maxsize=None)
def _frame_symbols_len() -> int:
    return 64 + _frame_len(_HEADER_LEN, **_HEADER, bps=_BPS) \
        + _frame_len(_PAYLOAD_LEN, **_PAYLOAD, bps=_BPS) + 2 * _M


def frame64_len() -> int:
    """Samples per frame64 (computed lazily, on the host: no device work)."""
    return _frame_symbols_len() * _K


def __getattr__(name):
    if name == "FRAME64_LEN":
        return frame64_len()
    raise AttributeError(name)


def _shape(symbols: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Zero-stuff to k samples/symbol and pulse-shape (the first
    k·len(symbols) outputs of the convolution), complex128 on the symbols'
    device, returned as complex64."""
    n = symbols.shape[0] * _K
    L = h.shape[0]
    up = torch.zeros(L - 1 + n, dtype=torch.complex128, device=symbols.device)
    up[L - 1::_K] = symbols.to(torch.complex128)
    return (up.unfold(0, L, 1) @ h.flip(0).to(torch.complex128)).to(torch.complex64)


class FrameGen64:
    """Burst frame generator (liquid ``framegen64``), on ``device`` (the
    current CUDA device by default)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.header_pm = _header_pm(self.device)
        self.payload_pm = _payload_pm(self.device)
        self.frame_len = frame64_len()
        self._h = torch.from_numpy(_pulse()).to(self.device)
        self._pre = torch.from_numpy(_preamble_symbols()).to(self.device)
        self._tail = torch.zeros(2 * _M, dtype=torch.complex64, device=self.device)

    def execute(self, header, payload) -> torch.Tensor:
        """header [8] bytes, payload [64] bytes -> samples [FRAME64_LEN]
        (complex64, on the device)."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        if header.size != _HEADER_LEN:
            raise ConfigError(f"header length {header.size} != {_HEADER_LEN}")
        if payload.size != _PAYLOAD_LEN:
            raise ConfigError(
                f"payload length {payload.size} != {_PAYLOAD_LEN}")
        syms = torch.cat([
            self._pre,
            self.header_pm.encode(header),
            self.payload_pm.encode(payload),
            self._tail,  # flush the pulse tail
        ])
        return _shape(syms, self._h)


class FrameSync64:
    """Burst frame synchronizer (liquid ``framesync64``), on ``device`` (the
    current CUDA device by default).

    ``execute(x)`` searches the buffer and returns None (no detection) or a
    dict: header/payload byte arrays (numpy uint8), header_valid /
    payload_valid CRC flags, and stats {rxy, tau, dphi, phi, gamma, evm_db}.
    """

    def __init__(self, threshold: float = 0.45, dphi_max: float = 0.02,
                 n_dphi: int = 13, device=None):
        self.device = resolve_device(device)
        self.header_pm = _header_pm(self.device)
        self.payload_pm = _payload_pm(self.device)
        self._h = torch.from_numpy(_pulse()).to(self.device)
        self._pre = torch.from_numpy(_preamble_symbols()).to(self.device)
        template = _shape(self._pre, self._h)  # includes the tx ramp-up
        self.detector = QDetector(template, threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi, device=self.device)
        self._nsyms = _frame_symbols_len()
        self._debug = None

    def execute(self, x):
        x = _sync.as_samples(x, self.device)
        det = self.detector.detect(x)
        self._debug = {"x": x, "det": det, "syms": None}
        if det is None:
            return None
        aligned = self._align(x, det)
        return None if aligned is None else self._decode(*aligned, det)

    def _align(self, x: torch.Tensor, det: dict):
        """The frame's symbols after timing and carrier recovery (complex128)
        and the preamble fit's slope b, or None for a frame the buffer
        truncates."""
        y, i0 = _sync.derotate(x, det)
        # matched filter (full), symbol i of the frame peaks at
        # i0 + (h_len - 1) + i*k in the filtered stream
        d = self._h.shape[0] - 1
        if i0 + d + _K * (self._nsyms - 1) >= x.shape[0] + d:
            return None  # frame truncated by the buffer edge
        syms = _sync.matched_symbols(y, self._h, i0, _K, self._nsyms)
        self._debug["syms"] = syms
        # residual carrier: LSQ linear phase fit on the known preamble
        a, b, amp = _sync.phase_fit(syms, self._pre)
        return _sync.correct(syms, a, b, amp), b

    def _decode(self, syms: torch.Tensor, b: torch.Tensor, det: dict) -> dict:
        """Split and decode the header and payload; the stats."""
        hlen = self.header_pm.get_frame_len()
        plen = self.payload_pm.get_frame_len()
        header, hok = self.header_pm.decode_soft(syms[64: 64 + hlen])
        payload, pok = self.payload_pm.decode_soft(syms[64 + hlen: 64 + hlen + plen])
        # EVM over the preamble (known symbols)
        b, evm = torch.stack([b, _sync.evm_db(syms, self._pre)]).tolist()
        return {
            "header": header, "header_valid": bool(hok),
            "payload": payload, "payload_valid": bool(pok),
            "stats": {
                "rxy": det["rxy"], "tau": det["tau"],
                "dphi": det["dphi"] + b / _K,  # refined CFO (rad/sample)
                "phi": det["phi"], "gamma": det["gamma"], "evm_db": float(evm),
            },
        }

    def debug_export(self, path: str) -> None:
        """Write the last processed buffer/symbols as an Octave script
        (liquid ``framesync64_debug_export``; framesync64_debug_{user,
        ndet,head} autotests: export succeeds whether or not the last
        buffer produced a detection or a decodable header)."""
        dbg = self._debug
        if dbg is None:
            raise ConfigError("no buffer processed yet; nothing to export")

        def _wvec(fh, name, v):
            fh.write("%s = [" % name)
            fh.write(" ".join("(%r+%rj)" % (float(s.real), float(s.imag))
                              for s in v.cpu().numpy().ravel()))
            fh.write("];\n")

        with open(path, "w") as fh:
            fh.write("%% %s: auto-generated by yagi_tpu_torch FrameSync64\n"
                     % path)
            fh.write("clear all; close all;\n")
            fh.write("num_samples = %d;\n" % dbg["x"].shape[0])
            _wvec(fh, "x", dbg["x"])
            det = dbg["det"]
            fh.write("frame_detected = %d;\n" % (0 if det is None else 1))
            if det is not None:
                fh.write("tau_hat = %r; dphi_hat = %r; gamma_hat = %r;\n"
                         % (float(det["tau"]), float(det["dphi"]),
                            float(det["gamma"])))
            if dbg["syms"] is not None:
                _wvec(fh, "syms", dbg["syms"])
