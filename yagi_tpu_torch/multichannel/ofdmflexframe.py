"""ofdmflexframe: OFDM burst frame with in-band signaled payload format.

Port of :mod:`yagi_tpu.multichannel.ofdmflexframe` (behavioral spec:
liquid-dsp's ofdmflexframegen/ofdmflexframesync, LIQUID_COMPAT.md:1106-1120):
an OFDM burst (M subcarriers, cyclic prefix, S0/S1 sync preamble) carrying
a protected header that signals the payload configuration (length,
modulation, CRC, two FEC levels) followed by the payload; the synchronizer
detects the frame, equalizes, decodes the header, builds the payload
decoder, and validates the payload. The header and protocol are
flexframe's (:mod:`yagi_tpu_torch.framing.flexframe`).

Where it runs: the OFDM (de)modulation is the port's
:class:`~.ofdm.OfdmFrameGen`/:class:`~.ofdm.OfdmFrameSync` on the object's
device (one batched FFT over [num_symbols, M]; its pilot fit over the
pilots' angles about their circular mean, so a long payload at a carrier
offset keeps every symbol); the header and payload bit work is the
:class:`~yagi_tpu_torch.framing.QPacketModem` (modem and soft levels on the
device, byte stages on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..framing._sync import as_samples
from ..framing.flexframe import _check_frame, _header_pm, _payload_pm, _props, _protocol
from ..framing.qpacketmodem import QPacketModem
from .ofdm import OfdmFrameGen, OfdmFrameSync

__all__ = ["OfdmFlexFrameGen", "OfdmFlexFrameSync"]


class OfdmFlexFrameGen:
    """OFDM flexible frame generator (liquid ``ofdmflexframegen``), on
    ``device`` (the current CUDA device by default)."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None, header_len: int = 14,
                 device=None):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.device = resolve_device(device)
        self.gen = OfdmFrameGen(M, cp_len, sctype, device=self.device)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len, self.device)

    def assemble(self, header, payload, mod_scheme: str = "qpsk", crc: str = "crc32",
                 fec0: str = "none", fec1: str = "none") -> torch.Tensor:
        """Build one OFDM frame: time samples, complex64 on the device."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        _check_frame(header, payload, self.header_len)
        protocol = _protocol(payload.size, mod_scheme, crc, fec0, fec1)
        payload_pm = QPacketModem(payload.size, crc=crc, fec0=fec0, fec1=fec1,
                                  mod_scheme=mod_scheme, device=self.device)
        syms = torch.cat([self.header_pm.encode(np.concatenate([header, protocol])),
                          payload_pm.encode(payload)])
        nd = self.gen.n_data
        n_ofdm = -(-syms.shape[0] // nd)
        grid = torch.zeros(n_ofdm * nd, dtype=torch.complex64, device=self.device)
        grid[: syms.shape[0]] = syms
        return self.gen.assemble(grid.reshape(n_ofdm, nd))


class OfdmFlexFrameSync:
    """OFDM flexible frame synchronizer (liquid ``ofdmflexframesync``), on
    ``device`` (the current CUDA device by default)."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None, header_len: int = 14,
                 threshold: float = 0.6, device=None):
        self.device = resolve_device(device)
        self.sync = OfdmFrameSync(M, cp_len, sctype, threshold=threshold, device=self.device)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len, self.device)

    def execute(self, x):
        """Search buffer ``x``; None or a dict with header/payload/props/stats."""
        x = as_samples(x, self.device)
        nd, sym_len = self.sync.n_data, self.sync.sym_len
        hlen = self.header_pm.get_frame_len()
        n_hdr_ofdm = -(-hlen // nd)
        # enough buffer for preamble + header OFDM symbols?
        if x.shape[0] < (3 + n_hdr_ofdm) * sym_len:
            return None
        res = self.sync.execute(x, n_hdr_ofdm)
        if res is None:
            return None
        header_all, hok = self.header_pm.decode_soft(res["symbols"].reshape(-1)[:hlen])
        user = header_all[: self.header_len]
        props = _props(header_all[self.header_len:]) if hok else None
        out = {"header": user, "header_valid": bool(hok), "payload": None,
               "payload_valid": False, "props": props, "stats": res["stats"]}
        if props is None:
            return out
        payload_pm = _payload_pm(props, self.device)
        total = hlen + payload_pm.get_frame_len()
        n_ofdm = -(-total // nd)
        if x.shape[0] < (3 + n_ofdm) * sym_len:
            return out
        res2 = self.sync.execute(x, n_ofdm)
        if res2 is None:
            return out
        payload, pok = payload_pm.decode_soft(res2["symbols"].reshape(-1)[hlen: total])
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": res2["stats"]}
