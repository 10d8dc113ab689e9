"""Packetizer: CRC + two-level FEC + interleaving (liquid ``packetizer``).

Port of :mod:`yagi_tpu.fec.packetizer` (behavioral spec: liquid-dsp's
packetizer, LIQUID_COMPAT.md fec rows): encode pipeline ``payload -> append
CRC key -> inner FEC -> interleave -> outer FEC -> interleave``; decode runs
the inverse chain and reports CRC validity.

Where each part runs: the byte stages (CRC, the inner code, the
interleavers' permutations) are packet-rate work on the host in numpy, as
in yagi_tpu; payloads are numpy ``uint8`` and CRC flags Python ``bool``.
:meth:`Packetizer.decode_soft` keeps soft levels on the object's device: the
outer interleaver's inverse permutation is a gather there, and a
convolutional outer code decodes there (the Viterbi decoder).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from .api import Fec, FecScheme, _as_bytes, fec_get_enc_msg_length
from .conv import levels_tensor
from .crc import CrcScheme, crc_generate_key, crc_sizeof_key, crc_validate_message
from .interleave import Interleaver

__all__ = ["Packetizer"]


def _lengths(msg_len: int, crc, fec0, fec1) -> tuple[int, int, int]:
    """(payload + key, after the inner code, after the outer code) in bytes."""
    len0 = msg_len + crc_sizeof_key(crc)
    len1 = fec_get_enc_msg_length(fec0, len0)
    return len0, len1, fec_get_enc_msg_length(fec1, len1)


class Packetizer:
    """Composable packet encoder/decoder.

    Parameters mirror ``packetizer_create(msg_len, crc, fec0, fec1)``; its
    codes decode on ``device`` (the current CUDA device by default).
    """

    def __init__(self, msg_len: int, crc: CrcScheme | str = "crc32",
                 fec0: FecScheme | str = "none",
                 fec1: FecScheme | str = "none", device=None):
        if msg_len < 1:
            raise ConfigError(f"msg_len ({msg_len}) must be >= 1")
        self.msg_len = msg_len
        self.crc = CrcScheme(crc)
        self.device = resolve_device(device)
        self.fec0 = Fec(fec0, self.device)
        self.fec1 = Fec(fec1, self.device)
        self._len0, self._len1, self.enc_len = _lengths(msg_len, self.crc, fec0, fec1)
        self._il0 = Interleaver(self._len1)
        self._il1 = Interleaver(self.enc_len)
        self._iperm1 = torch.from_numpy(self._il1._iperm).to(self.device)

    def get_enc_msg_length(self) -> int:
        return self.enc_len

    def encode(self, payload) -> np.ndarray:
        payload = _as_bytes(payload)
        if payload.shape[-1] != self.msg_len:
            raise ConfigError(
                f"payload length {payload.shape[-1]} != msg_len ({self.msg_len})")
        key = crc_generate_key(self.crc, payload)
        nk = crc_sizeof_key(self.crc)
        key_bytes = np.array(
            [(key >> (8 * (nk - 1 - i))) & 0xFF for i in range(nk)], np.uint8)
        stage = np.concatenate([payload, key_bytes])
        stage = self.fec0.encode(stage)
        stage = self._il0.encode(stage)
        stage = self.fec1.encode(stage)
        return self._il1.encode(stage)

    def _check(self, stage: np.ndarray):
        """(payload, crc_pass) from the inner code's decoded bytes."""
        payload = stage[: self.msg_len]
        nk = crc_sizeof_key(self.crc)
        key = 0
        for b in stage[self.msg_len: self.msg_len + nk]:
            key = (key << 8) | int(b)
        ok = crc_validate_message(self.crc, payload, key) \
            if self.crc != CrcScheme.NONE else True
        return payload, bool(ok)

    def decode(self, enc):
        """Returns (payload [msg_len] uint8, crc_pass bool)."""
        enc = _as_bytes(enc)
        if enc.shape[-1] != self.enc_len:
            raise ConfigError(
                f"encoded length {enc.shape[-1]} != enc_len ({self.enc_len})")
        stage = self._il1.decode(enc)
        stage = self.fec1.decode(stage, self._len1)
        stage = self._il0.decode(stage)
        return self._check(self.fec0.decode(stage, self._len0))

    def decode_soft(self, levels):
        """Soft-decision decode from per-bit levels in [0,1] (one level per
        encoded bit, 8*enc_len total; a numpy array or a tensor). The outer
        interleaver permutation is applied to the soft levels as a gather on
        the device, so the outer FEC (typically a convolutional code) decodes
        from soft inputs there; inner stages proceed on hard bytes on the
        host, as in liquid's packetizer."""
        levels = levels_tensor(levels, self.device)
        if levels.shape[0] != 8 * self.enc_len:
            raise ConfigError(
                f"soft length {levels.shape[0]} != 8*enc_len "
                f"({8 * self.enc_len})")
        stage = self.fec1.decode_soft(levels[self._iperm1], self._len1)
        stage = self._il0.decode(stage)
        return self._check(self.fec0.decode(stage, self._len0))
