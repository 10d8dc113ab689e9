"""qpacketmodem: packet encoder/modulator + demodulator/decoder.

Port of :mod:`yagi_tpu.framing.qpacketmodem` (behavioral spec: liquid-dsp's
qpacketmodem, LIQUID_COMPAT.md:1009-1283): a payload byte message is
protected by the packetizer (CRC + two FEC levels + interleaving) and mapped
to modem symbols; the receiver demodulates (hard or soft) and runs the
inverse chain, reporting CRC validity.

Where each part runs: the packetizer's byte stages stay on the host in
numpy, as in yagi_tpu; modulation and demodulation are the port's
:class:`~yagi_tpu_torch.modem.Modem` on the object's device, and so are the
soft levels (soft bytes / 255 in float32, as yagi_tpu) up to a
convolutional outer code's Viterbi decoder. Samples are complex64 tensors
on the device; payloads numpy ``uint8``, flags Python ``bool``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..fec import Packetizer
from ..fec._bits import pack_bits, unpack_bits
from ..fec.packetizer import _lengths
from ..modem.modem import Modem
from ._sync import as_samples

__all__ = ["QPacketModem"]


def _frame_len(payload_len: int, crc, fec0, fec1, bps: int) -> int:
    """Modem symbols of a packet (zero-padded to whole symbols)."""
    return -(-8 * _lengths(payload_len, crc, fec0, fec1)[2] // bps)


class QPacketModem:
    """Packet modem (liquid ``qpacketmodem``).

    Parameters mirror ``qpacketmodem_create(payload_len, crc, fec0, fec1,
    ms)``; it runs on ``device`` (the current CUDA device by default).
    """

    def __init__(self, payload_len: int, crc="crc32", fec0="none",
                 fec1="none", mod_scheme="qpsk", device=None):
        self.device = resolve_device(device)
        self.packetizer = Packetizer(payload_len, crc=crc, fec0=fec0,
                                     fec1=fec1, device=self.device)
        self.modem = Modem.create(mod_scheme, device=self.device)
        self.payload_len = payload_len
        self.bps = self.modem.get_bps()
        self.frame_len = _frame_len(payload_len, crc, fec0, fec1, self.bps)

    def get_frame_len(self) -> int:
        """Number of modem symbols per packet (liquid
        ``qpacketmodem_get_frame_len``)."""
        return self.frame_len

    def get_payload_len(self) -> int:
        return self.payload_len

    # ------------------------------------------------------------- encode

    def encode_syms(self, payload) -> np.ndarray:
        """Payload bytes -> symbol indices [frame_len] (numpy uint32)."""
        enc = self.packetizer.encode(payload)
        bits = unpack_bits(enc)
        pad = self.frame_len * self.bps - bits.shape[-1]
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
        groups = bits.reshape(self.frame_len, self.bps)
        weights = (1 << np.arange(self.bps - 1, -1, -1)).astype(np.int64)
        return (groups.astype(np.int64) @ weights).astype(np.uint32)

    def encode(self, payload) -> torch.Tensor:
        """Payload bytes -> modulated samples [frame_len] (complex64, on the
        device)."""
        samples, _ = self.modem.modulate(self.encode_syms(payload))
        return samples

    # ------------------------------------------------------------- decode

    def _bits_from_syms(self, syms: np.ndarray) -> np.ndarray:
        bits = (syms[:, None].astype(np.int64)
                >> np.arange(self.bps - 1, -1, -1)) & 1
        return bits.reshape(-1)[: 8 * self.packetizer.enc_len].astype(np.uint8)

    def _samples(self, samples) -> torch.Tensor:
        samples = as_samples(samples, self.device)
        if samples.shape[0] != self.frame_len:
            raise ConfigError(
                f"frame length {samples.shape[0]} != {self.frame_len}")
        return samples

    def decode_syms(self, syms):
        """Hard symbol indices [frame_len] -> (payload, crc_pass)."""
        if isinstance(syms, torch.Tensor):
            syms = syms.cpu().numpy()
        syms = np.asarray(syms).ravel()
        if syms.shape[0] != self.frame_len:
            raise ConfigError(
                f"frame length {syms.shape[0]} != {self.frame_len}")
        enc = pack_bits(self._bits_from_syms(syms))
        return self.packetizer.decode(enc)

    def decode(self, samples):
        """Received samples [frame_len] -> (payload, crc_pass), hard
        decisions."""
        syms, _ = self.modem.demodulate(self._samples(samples))
        return self.decode_syms(syms)

    def decode_soft(self, samples):
        """Received samples -> (payload, crc_pass) via per-bit soft
        decisions (liquid ``qpacketmodem_decode_soft``), kept on the device
        up to the packetizer."""
        _, soft, _ = self.modem.demodulate_soft(self._samples(samples))
        levels = soft.reshape(-1).to(torch.float32) / 255.0
        return self.packetizer.decode_soft(levels[: 8 * self.packetizer.enc_len])
