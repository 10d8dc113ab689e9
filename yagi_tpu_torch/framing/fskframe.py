"""fskframe: FSK-modulated burst frame generator + synchronizer.

Port of :mod:`yagi_tpu.framing.fskframe` (behavioral spec: liquid-dsp's
fskframegen/fskframesync, LIQUID_COMPAT.md:1073-1076): a burst frame
carried on M-ary FSK (m bits/symbol, k samples/symbol, bandwidth bw) — p/n
preamble, protected header carrying the payload configuration (length,
CRC, FEC levels), protected payload; the synchronizer detects the burst,
removes the carrier offset, and decodes non-coherently (FSK tone energies
ignore carrier phase and channel gain). The wire format is yagi_tpu's,
sample for sample.

Where it runs: the symbol-to-byte helpers, the protocol bytes and the
packetizer on the host in numpy, as in yagi_tpu; the modulation and
demodulation (the port's :class:`~yagi_tpu_torch.modem.Fskmod` /
:class:`~yagi_tpu_torch.modem.Fskdem`, one batched FFT), the detection and
the carrier removal on the object's device. Timing is ``int(round(tau))``
of the detection's host float, as in yagi_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import pack_bits, unpack_bits
from ..modem.fsk import Fskdem, Fskmod
from ..sequence.msequence import MSequence
from ._sync import as_samples
from .gmskframe import check_frame, props5, protocol5
from .qdetector import QDetector

__all__ = ["FskFrameGen", "FskFrameSync"]

_PRE_SYMS = 64
_PROTOCOL_BYTES = 5


def _preamble_symbols(m: int) -> np.ndarray:
    ms = MSequence.create_default(7)
    M = 1 << m
    out = np.empty(_PRE_SYMS, dtype=np.int32)
    for i in range(_PRE_SYMS):
        v = 0
        for _ in range(m):
            v = (v << 1) | ms.advance()
        out[i] = v % M
    return out


def _header_pk(user_len: int, device) -> Packetizer:
    return Packetizer(user_len + _PROTOCOL_BYTES, crc="crc32", fec0="golay2412", fec1="none",
                      device=device)


def _bytes_to_syms(data: np.ndarray, m: int) -> np.ndarray:
    bits = unpack_bits(data)
    pad = (-bits.size) % m
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    groups = bits.reshape(-1, m)
    weights = (1 << np.arange(m - 1, -1, -1)).astype(np.int64)
    return (groups.astype(np.int64) @ weights).astype(np.int32)


def _syms_to_bytes(syms: np.ndarray, m: int, nbytes: int) -> np.ndarray:
    bits = ((syms[:, None].astype(np.int64) >> np.arange(m - 1, -1, -1)) & 1).reshape(-1)
    return pack_bits(bits[: 8 * nbytes].astype(np.uint8))


class FskFrameGen:
    """FSK burst frame generator (liquid ``fskframegen``), on ``device``
    (the current CUDA device by default)."""

    def __init__(self, m: int = 1, k: int = 8, bandwidth: float = 0.25, header_len: int = 8,
                 device=None):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.device = resolve_device(device)
        self.m, self.k, self.bandwidth = m, k, float(bandwidth)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len, self.device)
        Fskmod.create(m, k, bandwidth, device=self.device)  # validates m/k/bandwidth

    def assemble(self, header, payload, crc: str = "crc32", fec0: str = "none",
                 fec1: str = "none") -> torch.Tensor:
        """Build one frame: samples, complex64 on the device."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        check_frame(header, payload, self.header_len)
        protocol = protocol5(payload.size, crc, fec0, fec1)
        payload_pk = Packetizer(payload.size, crc=crc, fec0=fec0, fec1=fec1, device=self.device)
        syms = np.concatenate([
            _preamble_symbols(self.m),
            _bytes_to_syms(self.header_pk.encode(np.concatenate([header, protocol])), self.m),
            _bytes_to_syms(payload_pk.encode(payload), self.m),
        ])
        y, _ = Fskmod.create(self.m, self.k, self.bandwidth, device=self.device).modulate(syms)
        return y


class FskFrameSync:
    """FSK burst frame synchronizer (liquid ``fskframesync``), on ``device``
    (the current CUDA device by default)."""

    def __init__(self, m: int = 1, k: int = 8, bandwidth: float = 0.25, header_len: int = 8,
                 threshold: float = 0.5, dphi_max: float = 0.02, n_dphi: int = 13,
                 device=None):
        self.device = resolve_device(device)
        self.m, self.k, self.bandwidth = m, k, float(bandwidth)
        self.header_len = header_len
        self.header_pk = _header_pk(header_len, self.device)
        self.preamble = _preamble_symbols(m)
        template, _ = Fskmod.create(m, k, bandwidth, device=self.device).modulate(self.preamble)
        self.detector = QDetector(template, threshold=threshold, dphi_max=dphi_max,
                                  n_dphi=n_dphi, device=self.device)
        self._pre = torch.from_numpy(self.preamble).to(self.device)

    def _hdr_nsyms(self) -> int:
        return -(-8 * self.header_pk.enc_len // self.m)

    def execute(self, x):
        """Search buffer ``x``; None or a dict with header/payload/props/stats."""
        x = as_samples(x, self.device)
        det = self.detector.detect(x)
        if det is None:
            return None
        i0 = int(round(det["tau"]))
        n = torch.arange(i0, x.shape[0], dtype=torch.float64, device=self.device)
        # carrier removal (phase and gain are moot), from the burst on
        y = (x[i0:].to(torch.complex128)
             * torch.polar(torch.ones_like(n), -det["dphi"] * n)).to(torch.complex64)
        navail = y.shape[0] // self.k
        hdr_nsyms = self._hdr_nsyms()
        if navail < _PRE_SYMS + hdr_nsyms:
            return None
        dem = Fskdem.create(self.m, self.k, self.bandwidth, device=self.device)
        syms_t, _ = dem.demodulate(y[: navail * self.k])
        pre_match = float((syms_t[:_PRE_SYMS] == self._pre).to(torch.float64).mean())
        syms = syms_t.cpu().numpy()
        header_all, hok = self.header_pk.decode(
            _syms_to_bytes(syms[_PRE_SYMS: _PRE_SYMS + hdr_nsyms], self.m,
                           self.header_pk.enc_len))
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
        pl_nsyms = -(-8 * payload_pk.enc_len // self.m)
        off = _PRE_SYMS + hdr_nsyms
        if syms.size < off + pl_nsyms:
            return out
        payload, pok = payload_pk.decode(
            _syms_to_bytes(syms[off: off + pl_nsyms], self.m, payload_pk.enc_len))
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": stats}
