"""gmskframe: GMSK-modulated burst frame generator + synchronizer.

Port of :mod:`yagi_tpu.framing.gmskframe` (behavioral spec: liquid-dsp's
gmskframegen/gmskframesync, LIQUID_COMPAT.md:1079-1092): a
constant-envelope burst — p/n preamble, protected header carrying the
payload configuration (length, CRC, FEC levels), protected payload —
GMSK-modulated at k samples/symbol with bandwidth-time product bt; the
synchronizer detects the burst at unknown delay, carrier and gain, removes
the timing and carrier offsets (the frequency discriminator ignores phase
and gain), and decodes header and payload from soft decisions. The wire
format is yagi_tpu's, sample for sample.

Where it runs: the header and payload bits (packetizer, protocol bytes) on
the host in numpy, as in yagi_tpu; the modulation (the port's
:class:`~yagi_tpu_torch.modem.GmskMod`), the detection, the carrier
removal and FFT fractional delay (complex128), the discriminator and the
receive matched filter at the decision instants (float32, one strided
banded matmul) and the soft levels on the object's device. The soft scale
is the median of the 64 preamble magnitudes as numpy takes it: the mean of
the two middle values (``torch.median`` would return the lower one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import unpack_bits
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..filter._conv import causal_conv_valid
from ..modem.cpm import GmskDem, GmskMod
from ..sequence.msequence import MSequence
from ._sync import as_samples
from .qdetector import QDetector

__all__ = ["GmskFrameGen", "GmskFrameSync"]

_PRE_LEN = 64       # preamble bits
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 5  # payload_len u16 + crc id + fec0 id + fec1 id


def _preamble_bits() -> np.ndarray:
    ms = MSequence.create_default(7)
    return np.array([ms.advance() for _ in range(_PRE_LEN)], dtype=np.uint8)


def _header_pk(user_len: int, device) -> Packetizer:
    return Packetizer(user_len + _PROTOCOL_BYTES, crc="crc32", fec0="golay2412", fec1="none",
                      device=device)


def protocol5(payload_len: int, crc: str, fec0: str, fec1: str) -> np.ndarray:
    """The five protocol bytes of the GMSK and FSK frames: payload length
    (u16, big-endian) and the CRC and two FEC ids."""
    try:
        ids = (_CRC_IDS.index(CrcScheme(crc).value), _FEC_IDS.index(FecScheme(fec0).value),
               _FEC_IDS.index(FecScheme(fec1).value))
    except ValueError as e:
        raise ConfigError(f"invalid payload property: {e}") from e
    return np.array([payload_len >> 8, payload_len & 0xFF, *ids], dtype=np.uint8)


def props5(proto: np.ndarray) -> dict | None:
    """The payload properties the five protocol bytes signal, or None."""
    payload_len = (int(proto[0]) << 8) | int(proto[1])
    crc_id, fec0_id, fec1_id = int(proto[2]), int(proto[3]), int(proto[4])
    if (payload_len < 1 or crc_id >= len(_CRC_IDS) or fec0_id >= len(_FEC_IDS)
            or fec1_id >= len(_FEC_IDS)):
        return None
    return {"crc": _CRC_IDS[crc_id], "fec0": _FEC_IDS[fec0_id], "fec1": _FEC_IDS[fec1_id],
            "payload_len": payload_len}


def check_frame(header: np.ndarray, payload: np.ndarray, header_len: int) -> None:
    if header.size != header_len:
        raise ConfigError(f"header length {header.size} != {header_len}")
    if payload.size < 1 or payload.size > 65535:
        raise ConfigError(f"payload length ({payload.size}) must be in [1, 65535]")


def median(v: torch.Tensor) -> torch.Tensor:
    """numpy's median of a 1-D tensor: the middle value, or the mean of the
    two middle values for an even count (``torch.median`` takes the lower)."""
    s = v.sort().values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


class GmskFrameGen:
    """GMSK burst frame generator (liquid ``gmskframegen``), on ``device``
    (the current CUDA device by default)."""

    def __init__(self, k: int = 2, m: int = 3, bt: float = 0.5, header_len: int = 8,
                 device=None):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.device = resolve_device(device)
        self.k, self.m, self.bt = k, m, float(bt)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len, self.device)
        # constructing the modulator validates k/m/bt
        GmskMod.create(k=k, m=m, bt=bt, device=self.device)

    def assemble(self, header, payload, crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> torch.Tensor:
        """Build one frame: samples, complex64 on the device."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        check_frame(header, payload, self.header_len)
        protocol = protocol5(payload.size, crc, fec0, fec1)
        payload_pk = Packetizer(payload.size, crc=crc, fec0=fec0, fec1=fec1, device=self.device)
        bits = np.concatenate([
            _preamble_bits(),
            unpack_bits(self.header_pk.encode(np.concatenate([header, protocol]))),
            unpack_bits(payload_pk.encode(payload)),
            np.zeros(4 * self.m, dtype=np.uint8),  # flush tx+rx filters
        ])
        y, _ = GmskMod.create(k=self.k, m=self.m, bt=self.bt, device=self.device).modulate(bits)
        return y


class GmskFrameSync:
    """GMSK burst frame synchronizer (liquid ``gmskframesync``), on
    ``device`` (the current CUDA device by default)."""

    def __init__(self, k: int = 2, m: int = 3, bt: float = 0.5, header_len: int = 8,
                 threshold: float = 0.5, dphi_max: float = 0.02, n_dphi: int = 13,
                 device=None):
        self.device = resolve_device(device)
        self.k, self.m, self.bt = k, m, float(bt)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len, self.device)
        template, _ = GmskMod.create(k=k, m=m, bt=bt, device=self.device).modulate(
            _preamble_bits())
        self.detector = QDetector(template, threshold=threshold, dphi_max=dphi_max,
                                  n_dphi=n_dphi, device=self.device)
        self._rx_h = GmskDem.create(k=k, m=m, bt=bt, device=self.device).h
        self._pre = torch.from_numpy(_preamble_bits()).to(self.device)

    def _soft(self, x: torch.Tensor, det: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The decision-rate matched-filter values from the burst on (the
        preamble's first) and their soft levels in [0, 1]."""
        n = torch.arange(x.shape[0], dtype=torch.float64, device=self.device)
        y = x.to(torch.complex128) * torch.polar(torch.ones_like(n), -det["dphi"] * n)
        i0 = math.floor(det["tau"])
        frac = det["tau"] - i0
        if frac > 1e-6:  # sub-sample advance via FFT phase ramp
            f = torch.fft.fftfreq(y.shape[0], dtype=torch.float64, device=self.device)
            y = torch.fft.ifft(torch.fft.fft(y) * torch.polar(torch.ones_like(f),
                                                               2 * math.pi * f * frac))
        y = y[max(i0, 0):].to(torch.complex64).to(torch.complex128)
        shifted = torch.cat([y.new_ones(1), y[:-1]])
        fr = torch.angle(y * shifted.conj()).to(torch.float32)
        # causal convolution with the receive filter, read at every k-th
        # output: bit j is decided at z[j·k], delayed 2m bits (tx pulse m +
        # rx filter m)
        L = self._rx_h.shape[0]
        d = causal_conv_valid(torch.cat([fr.new_zeros(L - 1), fr]), self._rx_h, self.k)
        bits_sig = d[2 * self.m:]
        scale = median(bits_sig[:_PRE_LEN].abs()) + 1e-12
        soft = torch.clamp(0.5 + 0.5 * bits_sig / (2.0 * scale), 0.0, 1.0)
        return bits_sig, soft

    def execute(self, x):
        """Search buffer ``x``; None or a dict with header/payload/props/stats."""
        x = as_samples(x, self.device)
        det = self.detector.detect(x)
        if det is None:
            return None
        bits_sig, soft = self._soft(x, det)
        hdr_nbits = 8 * self.header_pk.enc_len
        if soft.shape[0] < _PRE_LEN + hdr_nbits:
            return None
        # preamble bit agreement (a bit-error proxy)
        pre_match = float(((bits_sig[:_PRE_LEN] > 0).to(torch.uint8) == self._pre).to(
            torch.float64).mean())
        header_all, hok = self.header_pk.decode_soft(soft[_PRE_LEN: _PRE_LEN + hdr_nbits])
        stats = {"rxy": det["rxy"], "tau": det["tau"], "dphi": det["dphi"],
                 "preamble_match": pre_match}
        user = header_all[: self.header_len]
        props = props5(header_all[self.header_len:]) if hok else None
        out = {"header": user, "header_valid": bool(hok), "payload": None,
               "payload_valid": False, "props": props, "stats": stats}
        if props is None:
            return out
        payload_pk = Packetizer(props["payload_len"], crc=props["crc"], fec0=props["fec0"],
                                fec1=props["fec1"], device=self.device)
        pl_nbits = 8 * payload_pk.enc_len
        off = _PRE_LEN + hdr_nbits
        if soft.shape[0] < off + pl_nbits:
            return out
        payload, pok = payload_pk.decode_soft(soft[off: off + pl_nbits])
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": stats}
