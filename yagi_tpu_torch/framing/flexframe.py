"""flexframe: flexible burst frame generator + synchronizer.

Port of :mod:`yagi_tpu.framing.flexframe` (behavioral spec: liquid-dsp's
flexframegen/flexframesync, LIQUID_COMPAT.md:1052-1055): like frame64 but
with a *runtime-configurable* payload — length, modulation scheme, CRC and
two FEC levels are chosen per frame and signaled in-band: the synchronizer
first decodes the fixed-format protected header, reads the payload
configuration from its protocol fields, then builds the payload decoder.

Wire format (yagi_tpu's, sample for sample): the 64-symbol BPSK p/n
preamble; header = [user header bytes | payload_len u16 | mod id | crc id |
fec0 id | fec1 id] under crc32 + Golay(24,12), QPSK; payload =
packetizer(crc, fec0, fec1) + the chosen modem; frame64's root-Nyquist
pulse at k = 2 samples/symbol.

Where it runs: the protocol bytes and the packetizer's byte stages on the
host in numpy, as in yagi_tpu; the pulse shaping, the derotation and FFT
fractional delay, the matched filter at the symbol instants and the
weighted phase fit over the *unwrapped* angles of the preamble (and, in
the second pass, of the re-encoded header) on the object's device in
complex128 (:mod:`._sync`). The derotation references the carrier ramp at
the burst (:func:`._sync.derotate`); yagi_tpu's references it at the
buffer's start (``flexframe.py:167``), and since the fit unwraps its
angles the two give the same symbols. The payload's decision-directed
phase tracking is :func:`._carrier.dd_track` (skipped for differential
schemes).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..modem.modem import Modem, ModulationScheme
from . import _sync
from ._carrier import dd_track
from .frame64 import _K, _M, _preamble_symbols, _pulse, _shape
from .qdetector import QDetector
from .qpacketmodem import QPacketModem

__all__ = ["FlexFrameGen", "FlexFrameSync"]

# in-band id tables: index <-> scheme name (wire protocol)
_MOD_IDS = tuple(s.value for s in ModulationScheme if s.value != "arb")
_CRC_IDS = tuple(s.value for s in CrcScheme)
_FEC_IDS = tuple(s.value for s in FecScheme)
_PROTOCOL_BYTES = 6


def _header_pm(user_len: int, device) -> QPacketModem:
    return QPacketModem(user_len + _PROTOCOL_BYTES, crc="crc32", fec0="golay2412",
                        fec1="none", mod_scheme="qpsk", device=device)


def _protocol(payload_len: int, mod_scheme: str, crc: str, fec0: str, fec1: str) -> np.ndarray:
    """The six protocol bytes: payload length (u16, big-endian) and the
    modulation, CRC and two FEC ids."""
    try:
        ids = (_MOD_IDS.index(ModulationScheme.from_str(mod_scheme).value),
               _CRC_IDS.index(CrcScheme(crc).value), _FEC_IDS.index(FecScheme(fec0).value),
               _FEC_IDS.index(FecScheme(fec1).value))
    except ValueError as e:
        raise ConfigError(f"invalid payload property: {e}") from e
    return np.array([payload_len >> 8, payload_len & 0xFF, *ids], dtype=np.uint8)


def _props(proto: np.ndarray) -> dict | None:
    """The payload properties the protocol bytes signal, or None where an id
    is out of range or the length is 0."""
    payload_len = (int(proto[0]) << 8) | int(proto[1])
    mod_id, crc_id, fec0_id, fec1_id = (int(v) for v in proto[2:6])
    if (payload_len < 1 or mod_id >= len(_MOD_IDS) or crc_id >= len(_CRC_IDS)
            or fec0_id >= len(_FEC_IDS) or fec1_id >= len(_FEC_IDS)):
        return None
    return {"mod_scheme": _MOD_IDS[mod_id], "crc": _CRC_IDS[crc_id],
            "fec0": _FEC_IDS[fec0_id], "fec1": _FEC_IDS[fec1_id], "payload_len": payload_len}


def _check_frame(header: np.ndarray, payload: np.ndarray, header_len: int) -> None:
    if header.size != header_len:
        raise ConfigError(f"header length {header.size} != {header_len}")
    if payload.size < 1 or payload.size > 65535:
        raise ConfigError(f"payload length ({payload.size}) must be in [1, 65535]")


def _payload_pm(props: dict, device) -> QPacketModem:
    return QPacketModem(props["payload_len"], crc=props["crc"], fec0=props["fec0"],
                        fec1=props["fec1"], mod_scheme=props["mod_scheme"], device=device)


class FlexFrameGen:
    """Flexible burst frame generator (liquid ``flexframegen``), on
    ``device`` (the current CUDA device by default).

    Payload properties are set per frame via :meth:`assemble` keyword
    arguments (liquid's ``flexframegenprops``): ``mod_scheme``, ``crc``,
    ``fec0``, ``fec1``.
    """

    def __init__(self, header_len: int = 14, device=None):
        if header_len < 0:
            raise ConfigError(f"header length ({header_len}) must be >= 0")
        self.device = resolve_device(device)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len, self.device)
        self._h = torch.from_numpy(_pulse()).to(self.device)
        self._pre = torch.from_numpy(_preamble_symbols()).to(self.device)
        self._tail = torch.zeros(2 * _M, dtype=torch.complex64, device=self.device)

    def assemble(self, header, payload, mod_scheme: str = "qpsk", crc: str = "crc32",
                 fec0: str = "none", fec1: str = "none") -> torch.Tensor:
        """Build one frame: samples [frame_len·k] (complex64, on the
        device)."""
        header = np.asarray(header, dtype=np.uint8).ravel()
        payload = np.asarray(payload, dtype=np.uint8).ravel()
        _check_frame(header, payload, self.header_len)
        protocol = _protocol(payload.size, mod_scheme, crc, fec0, fec1)
        payload_pm = QPacketModem(payload.size, crc=crc, fec0=fec0, fec1=fec1,
                                  mod_scheme=mod_scheme, device=self.device)
        syms = torch.cat([
            self._pre,
            self.header_pm.encode(np.concatenate([header, protocol])),
            payload_pm.encode(payload),
            self._tail,  # flush the pulse tail
        ])
        return _shape(syms, self._h)


class FlexFrameSync:
    """Flexible burst frame synchronizer (liquid ``flexframesync``), on
    ``device`` (the current CUDA device by default).

    ``execute(x)`` returns None or a dict with header/payload bytes (numpy
    uint8), validity flags, the signaled payload properties, and stats
    {rxy, tau, dphi, phi, gamma, evm_db}.
    """

    def __init__(self, header_len: int = 14, threshold: float = 0.45,
                 dphi_max: float = 0.02, n_dphi: int = 13, device=None):
        self.device = resolve_device(device)
        self.header_len = header_len
        self.header_pm = _header_pm(header_len, self.device)
        self._h = torch.from_numpy(_pulse()).to(self.device)
        self._pre = torch.from_numpy(_preamble_symbols()).to(self.device)
        self.detector = QDetector(_shape(self._pre, self._h), threshold=threshold,
                                  dphi_max=dphi_max, n_dphi=n_dphi, device=self.device)
        self._pre_idx = torch.arange(self._pre.shape[0], device=self.device)

    def _symbols(self, x: torch.Tensor, det: dict, nsym: int, known=None):
        """Carrier- and timing-corrected symbols (complex128; at most
        ``nsym``, fewer where the buffer ends) and the fit's slope b.

        ``known``: (positions, symbols) of known symbols past the preamble
        (the re-encoded header) that extend the linear-phase fit: a longer
        lever arm pins the residual-CFO slope."""
        y, i0 = _sync.derotate(x, det)
        nsym = min(nsym, (x.shape[0] - 1 - i0) // _K + 1)
        if nsym < self._pre.shape[0]:
            return None, None
        syms = _sync.matched_symbols(y, self._h, i0, _K, nsym)
        idx, ref = self._pre_idx, self._pre
        if known is not None:
            ki, ks = known
            keep = ki < nsym
            idx, ref = torch.cat([idx, ki[keep]]), torch.cat([ref, ks[keep]])
        a, b, amp = _sync.phase_fit(syms, ref, idx, unwrapped=True)
        return _sync.correct(syms, a, b, amp), b

    def _stats(self, det: dict, b: torch.Tensor, syms: torch.Tensor) -> dict:
        b, evm = torch.stack([b, _sync.evm_db(syms, self._pre)]).tolist()
        return {"rxy": det["rxy"], "tau": det["tau"], "dphi": det["dphi"] + b / _K,
                "phi": det["phi"], "gamma": det["gamma"], "evm_db": float(evm)}

    def execute(self, x):
        """Search buffer ``x`` (a tensor or a numpy array); None or a dict
        with header/payload/props/stats."""
        x = _sync.as_samples(x, self.device)
        det = self.detector.detect(x)
        if det is None:
            return None
        npre, hlen = self._pre.shape[0], self.header_pm.get_frame_len()
        # first pass: enough symbols for preamble + header
        syms, b = self._symbols(x, det, npre + hlen)
        if syms is None or syms.shape[0] < npre + hlen:
            return None
        header_all, hok = self.header_pm.decode_soft(syms[npre: npre + hlen])
        user = header_all[: self.header_len]
        props = _props(header_all[self.header_len:]) if hok else None
        if props is None:
            return {"header": user, "header_valid": bool(hok), "payload": None,
                    "payload_valid": False, "props": None, "stats": self._stats(det, b, syms)}
        payload_pm = _payload_pm(props, self.device)
        plen = payload_pm.get_frame_len()
        # second pass: the full frame, with the (now known) header symbols
        # extending the carrier fit past the preamble
        known = (npre + torch.arange(hlen, device=self.device),
                 self.header_pm.encode(header_all))
        syms, b = self._symbols(x, det, npre + hlen + plen, known=known)
        if syms.shape[0] < npre + hlen + plen:
            return {"header": user, "header_valid": True, "payload": None,
                    "payload_valid": False, "props": props, "stats": self._stats(det, b, syms)}
        pld_syms = syms[npre + hlen: npre + hlen + plen]
        # decision-directed phase tracking through the payload (liquid's
        # payload PLL analog); skipped for differential schemes, which are
        # insensitive to slow phase rotation by construction
        ms = props["mod_scheme"]
        if not (ms.startswith("dpsk") or ms == "pi4dqpsk"):
            pld_syms = dd_track(pld_syms, Modem.create(ms, device=self.device))
        payload, pok = payload_pm.decode_soft(pld_syms)
        return {"header": user, "header_valid": True, "payload": payload,
                "payload_valid": bool(pok), "props": props, "stats": self._stats(det, b, syms)}
