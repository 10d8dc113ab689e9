"""BPacketGen / BPacketSync: bit-level burst packet codec.

Port of :mod:`yagi_tpu.framing.bpacket` (behavioral spec: liquid-dsp's
``bpacketgen``/``bpacketsync``): a self-describing binary packet for links
that deliver raw demodulated *bits* (no carrier or timing — that is the
sample-level framers' job). The packet is

    [ phasing 0101.. | p/n sync word | encoded header | encoded payload ]

where the header carries (version, crc, fec0, fec1, payload length) under
its own fixed FEC so the receiver can reconfigure its payload decoder from
the header alone — the same in-band signaling contract as liquid's
bpacketgen (and FlexFrame at the sample level).

The sync word is the m = 6 default m-sequence (63 bits, one pad); the
receiver's seek state correlates the running bit window against it and
accepts up to ``pn_errors_max`` bit flips, so acquisition survives the
pre-FEC channel error rate.

Where it runs: a control-path, byte-rate object, on the host in numpy by
design, as in yagi_tpu; its packetizers are the port's
(:class:`~yagi_tpu_torch.fec.Packetizer`, built on ``device``, the current
CUDA device by default, where their decoders would run soft levels).
"""

from __future__ import annotations

import numpy as np

from .._src.device import resolve_device
from ..errors import ConfigError
from ..fec.api import FecScheme
from ..fec.crc import CrcScheme
from ..fec.packetizer import Packetizer
from ..sequence.msequence import MSequence

__all__ = ["BPacketGen", "BPacketSync"]

_VERSION = 1
_PHASING_BYTES = 8  # 64 alternating bits
_CRC_CODES = list(CrcScheme)
_FEC_CODES = list(FecScheme)
# header: version, crc code, fec0 code, fec1 code, payload_len (2 bytes)
_HEADER_LEN = 6
_HEADER_CRC = "crc16"
_HEADER_FEC = "hamming128"


def _pn_bits() -> np.ndarray:
    ms = MSequence.create_default(6)
    bits = np.asarray(ms.generate_bits(63), np.uint8)
    return np.concatenate([bits, np.zeros(1, np.uint8)])  # pad to 64


def _bytes_to_bits(b: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(b, np.uint8))


def _bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


class BPacketGen:
    """Assemble bit-level packets (liquid ``bpacketgen``); its packetizers
    on ``device`` (the current CUDA device by default)."""

    def __init__(self, payload_len: int, crc: str = "crc32",
                 fec0: str = "none", fec1: str = "none", device=None):
        if payload_len < 1 or payload_len > 0xFFFF:
            raise ConfigError(f"payload_len ({payload_len}) must be in [1, 65535]")
        self.payload_len = int(payload_len)
        self.crc = CrcScheme(crc)
        self.fec0 = FecScheme(fec0)
        self.fec1 = FecScheme(fec1)
        self.device = resolve_device(device)
        self._hdr_pk = Packetizer(_HEADER_LEN, _HEADER_CRC, _HEADER_FEC, device=self.device)
        self._pay_pk = Packetizer(self.payload_len, self.crc, self.fec0, self.fec1,
                                  device=self.device)
        self._pn = _pn_bits()

    def get_packet_len(self) -> int:
        """Total assembled packet length in bytes."""
        return (_PHASING_BYTES + self._pn.size // 8
                + self._hdr_pk.get_enc_msg_length()
                + self._pay_pk.get_enc_msg_length())

    def encode(self, payload) -> np.ndarray:
        """payload (payload_len bytes) → packet bytes."""
        header = np.array([
            _VERSION,
            _CRC_CODES.index(self.crc),
            _FEC_CODES.index(self.fec0),
            _FEC_CODES.index(self.fec1),
            (self.payload_len >> 8) & 0xFF,
            self.payload_len & 0xFF,
        ], np.uint8)
        return np.concatenate([
            np.full(_PHASING_BYTES, 0xAA, np.uint8),
            _bits_to_bytes(self._pn),
            self._hdr_pk.encode(header),
            self._pay_pk.encode(payload),
        ])


class BPacketSync:
    """Bit-stream packet synchronizer (liquid ``bpacketsync``).

    Feed raw received bytes/bits in any block sizes; ``callback(payload,
    crc_pass, header)`` fires once per recovered packet. The payload
    decoder is reconfigured from each decoded header, so one sync handles
    packets of any (crc, fec0, fec1, length) mix. Its packetizers are
    built on ``device`` (the current CUDA device by default).
    """

    def __init__(self, callback, pn_errors_max: int = 4, device=None):
        self.callback = callback
        self.pn_errors_max = int(pn_errors_max)
        self.device = resolve_device(device)
        self._hdr_pk = Packetizer(_HEADER_LEN, _HEADER_CRC, _HEADER_FEC, device=self.device)
        self._pn = _pn_bits().astype(np.int64)
        self.reset()
        # stats
        self.num_packets_found = 0

    def reset(self) -> None:
        self._state = "seek"
        self._win = np.zeros(self._pn.size, np.int64)  # running bit window
        self._nwin = 0
        self._acc: list = []
        self._need_bits = 0
        self._pay_pk: Packetizer | None = None
        self._header: dict | None = None

    # ------------------------------------------------------------------ I/O
    def execute(self, data) -> None:
        """Process received bytes (uint8 array / bytes)."""
        data = np.frombuffer(bytes(data), np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.asarray(data, np.uint8)
        self.execute_bits(_bytes_to_bits(data))

    def execute_bits(self, bits) -> None:
        bits = np.asarray(bits, np.uint8).ravel()
        i = 0
        n = bits.size
        while i < n:
            if self._state == "seek":
                i = self._seek(bits, i)
            else:
                take = min(self._need_bits - len(self._acc), n - i)
                self._acc.extend(bits[i: i + take].tolist())
                i += take
                if len(self._acc) == self._need_bits:
                    self._finish_section()

    # ------------------------------------------------------------ internals
    def _seek(self, bits: np.ndarray, i: int) -> int:
        """Find the p/n sequence in the bit stream (≤ pn_errors_max errors).

        Vectorized sliding correlation on ±1 bits (one np.convolve instead
        of an O(64·n) per-bit loop): errors[t] = (L − Σ s[t+j]·pn±[j]) / 2.
        Behaviorally identical to shifting one bit at a time through the
        window — the first full window with few enough errors wins.
        """
        L = self._pn.size
        avail = bits.size - i
        if avail <= 0:
            return bits.size
        prev = self._win[L - self._nwin :] if self._nwin else np.empty(0, np.int64)
        stream = np.concatenate([prev, bits[i:].astype(np.int64)])

        def _absorb_tail(end: int) -> None:
            tail = stream[max(0, end - L) : end]
            self._win[:] = 0
            self._win[L - tail.size :] = tail

        if stream.size >= L:
            s = 2 * stream - 1
            k = (2 * self._pn - 1)[::-1]
            corr = np.convolve(s, k, mode="valid")
            errors = (L - corr) // 2
            hits = np.nonzero(errors <= self.pn_errors_max)[0]
            if hits.size:
                t = int(hits[0])
                end = t + L  # stream index one past the matched window
                _absorb_tail(end)
                self._nwin = L
                self._state = "header"
                self._acc = []
                self._need_bits = 8 * self._hdr_pk.get_enc_msg_length()
                return i + (end - prev.size)
        # no match: absorb everything into the carried window
        _absorb_tail(stream.size)
        self._nwin = min(L, self._nwin + avail)
        return bits.size

    def _finish_section(self) -> None:
        section = np.array(self._acc, np.uint8)
        if self._state == "header":
            hdr, ok = self._hdr_pk.decode(_bits_to_bytes(section))
            if not ok or hdr[0] != _VERSION:
                self._restart_seek()
                return
            try:
                crc = _CRC_CODES[hdr[1]]
                fec0 = _FEC_CODES[hdr[2]]
                fec1 = _FEC_CODES[hdr[3]]
            except IndexError:
                self._restart_seek()
                return
            plen = (int(hdr[4]) << 8) | int(hdr[5])
            if plen < 1:
                self._restart_seek()
                return
            self._header = {"crc": crc, "fec0": fec0, "fec1": fec1,
                            "payload_len": plen}
            self._pay_pk = Packetizer(plen, crc, fec0, fec1, device=self.device)
            self._state = "payload"
            self._acc = []
            self._need_bits = 8 * self._pay_pk.get_enc_msg_length()
        else:  # payload
            payload, ok = self._pay_pk.decode(_bits_to_bytes(section))
            self.num_packets_found += 1
            self.callback(payload, ok, dict(self._header))
            self._restart_seek()

    def _restart_seek(self) -> None:
        self._state = "seek"
        self._win[:] = 0
        self._nwin = 0
        self._acc = []
