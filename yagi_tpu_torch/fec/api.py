"""Unified byte-message FEC API (liquid ``fec`` object analog).

Port of :mod:`yagi_tpu.fec.api` (behavioral spec: liquid-dsp's
``fec_create(scheme)`` / ``fec_encode`` / ``fec_decode`` /
``fec_get_enc_msg_length`` over byte messages, for every scheme in
LIQUID_COMPAT.md's fec rows: none, rep3/5, the Hamming family, SECDED,
Golay(24,12), conv27/29/39/615, punctured conv p23..p78, rs8).

Where each part runs: the byte and bit stages (packing, the block codes,
Golay, RS, encoding) are packet-rate work on the host in numpy, as in
yagi_tpu; decoded messages are numpy ``uint8``. The convolutional schemes
decode with the Viterbi decoder on the object's device
(:mod:`.conv`); soft levels may be a tensor there already. Lengths
(:func:`fec_get_enc_msg_length`) follow from the scheme and need no device.
"""

from __future__ import annotations

from enum import Enum
from functools import lru_cache

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ._bits import pack_bits, unpack_bits
from . import block as _block
from .golay import golay2412
from .conv import (conv27, conv29, conv39, conv615, conv_punctured, levels_tensor,
                   puncture_mask)
from .rs import rs8

__all__ = ["FecScheme", "Fec", "fec_get_enc_msg_length"]


class FecScheme(str, Enum):
    NONE = "none"
    REP3 = "rep3"
    REP5 = "rep5"
    HAMMING74 = "hamming74"
    HAMMING84 = "hamming84"
    HAMMING128 = "hamming128"
    HAMMING1511 = "hamming1511"
    HAMMING3126 = "hamming3126"
    GOLAY2412 = "golay2412"
    SECDED2216 = "secded2216"
    SECDED3932 = "secded3932"
    SECDED7264 = "secded7264"
    CONV27 = "conv27"
    CONV29 = "conv29"
    CONV39 = "conv39"
    CONV615 = "conv615"
    CONV27P23 = "conv27p23"
    CONV27P34 = "conv27p34"
    CONV27P45 = "conv27p45"
    CONV27P56 = "conv27p56"
    CONV27P67 = "conv27p67"
    CONV27P78 = "conv27p78"
    CONV29P23 = "conv29p23"
    CONV29P34 = "conv29p34"
    CONV29P45 = "conv29p45"
    CONV29P56 = "conv29p56"
    CONV29P67 = "conv29p67"
    CONV29P78 = "conv29p78"
    RS8 = "rs8"


_BLOCK_FACTORIES = {
    FecScheme.REP3: _block.rep3,
    FecScheme.REP5: _block.rep5,
    FecScheme.HAMMING74: _block.hamming74,
    FecScheme.HAMMING84: _block.hamming84,
    FecScheme.HAMMING128: _block.hamming128,
    FecScheme.HAMMING1511: _block.hamming1511,
    FecScheme.HAMMING3126: _block.hamming3126,
    FecScheme.GOLAY2412: golay2412,
    FecScheme.SECDED2216: _block.secded2216,
    FecScheme.SECDED3932: _block.secded3932,
    FecScheme.SECDED7264: _block.secded7264,
}

_CONV_FACTORIES = {
    FecScheme.CONV27: conv27,
    FecScheme.CONV29: conv29,
    FecScheme.CONV39: conv39,
    FecScheme.CONV615: conv615,
}

# (K, R) of each mother code: the lengths need no decoder tables
_CONV_KR = {"conv27": (7, 2), "conv29": (9, 2), "conv39": (9, 3), "conv615": (15, 6)}


def _parse_punctured(scheme: FecScheme):
    s = scheme.value
    if s.startswith("conv") and "p" in s[4:]:
        base = s[:6]
        p = int(s[7])
        return base, p
    return None


@lru_cache(maxsize=None)
def _geometry(scheme: FecScheme) -> tuple:
    """The scheme's lengths, on the host: ``("none",)``, ``("block", k, n)``,
    ``("conv", K, R, p)`` (p = 0 unpunctured) or ``("rs", k, nroots)``."""
    if scheme == FecScheme.NONE:
        return ("none",)
    if scheme in _BLOCK_FACTORIES:
        c = _BLOCK_FACTORIES[scheme]()
        return ("block", c.k, c.n)
    if scheme in _CONV_FACTORIES:
        return ("conv", *_CONV_KR[scheme.value], 0)
    if _parse_punctured(scheme):
        base, p = _parse_punctured(scheme)
        return ("conv", _CONV_KR[base][0], 2, p)
    c = rs8()
    return ("rs", c.k, c.nroots)


def _enc_bits_conv(scheme: FecScheme, dec_len: int) -> int:
    _, K, R, p = _geometry(scheme)
    T = 8 * dec_len + K - 1
    return int(puncture_mask(p, T).sum()) if p else R * T


def _enc_msg_length(scheme: FecScheme, dec_len: int) -> int:
    if dec_len < 0:
        raise ConfigError(f"dec_len ({dec_len}) must be >= 0")
    g = _geometry(scheme)
    if g[0] == "none":
        return dec_len
    if g[0] == "block":
        _, k, n = g
        nblocks = -(-8 * dec_len // k)
        return -(-nblocks * n // 8)
    if g[0] == "conv":
        return -(-_enc_bits_conv(scheme, dec_len) // 8)
    # rs: split into <=k-symbol blocks, each gains nroots parity
    _, k, nroots = g
    nblocks = max(1, -(-dec_len // k))
    return dec_len + nroots * nblocks


def _as_bytes(msg) -> np.ndarray:
    if isinstance(msg, (bytes, bytearray)):
        return np.frombuffer(bytes(msg), dtype=np.uint8)
    return np.asarray(msg, dtype=np.uint8)


class Fec:
    """Byte-message FEC codec for one scheme (liquid ``fec`` object); a
    convolutional scheme decodes on ``device`` (the current CUDA device by
    default)."""

    def __init__(self, scheme: FecScheme | str, device=None):
        self.scheme = FecScheme(scheme)
        self.device = resolve_device(device)
        self._kind = "none"
        self._codec = None
        if self.scheme == FecScheme.NONE:
            pass
        elif self.scheme in _BLOCK_FACTORIES:
            self._codec = _BLOCK_FACTORIES[self.scheme]()
            self._kind = "block"
        elif self.scheme in _CONV_FACTORIES:
            self._codec = _CONV_FACTORIES[self.scheme](self.device)
            self._kind = "conv"
        elif _parse_punctured(self.scheme):
            base, p = _parse_punctured(self.scheme)
            self._codec = conv_punctured(base, p, self.device)
            self._kind = "conv"
        elif self.scheme == FecScheme.RS8:
            self._codec = rs8()
            self._kind = "rs"
        else:  # pragma: no cover
            raise ConfigError(f"unknown FEC scheme {scheme!r}")

    @property
    def rate(self) -> float:
        return 1.0 if self._codec is None else self._codec.rate

    # -------- lengths --------

    def get_enc_msg_length(self, dec_len: int) -> int:
        """Encoded length in bytes for a dec_len-byte message
        (liquid ``fec_get_enc_msg_length``)."""
        return _enc_msg_length(self.scheme, dec_len)

    def _rs_block_sizes(self, dec_len: int):
        c = self._codec
        nblocks = max(1, -(-dec_len // c.k))
        base = dec_len // nblocks
        rem = dec_len - base * nblocks
        return [base + (1 if i < rem else 0) for i in range(nblocks)]

    # -------- encode / decode --------

    def encode(self, msg) -> np.ndarray:
        """Encode a byte message -> encoded byte array."""
        msg = _as_bytes(msg)
        n = msg.shape[-1]
        if self._kind == "none":
            return msg.copy()
        if self._kind == "block":
            c = self._codec
            bits = unpack_bits(msg)
            nblocks = -(-bits.shape[-1] // c.k)
            pad = nblocks * c.k - bits.shape[-1]
            if pad:
                bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
            cw = c.encode_bits(bits.reshape(nblocks, c.k))
            return pack_bits(cw.reshape(-1))
        if self._kind == "conv":
            bits = unpack_bits(msg)
            return pack_bits(self._codec.encode_bits(bits))
        # rs
        out = []
        pos = 0
        for bs in self._rs_block_sizes(n):
            blk = msg[pos: pos + bs].astype(np.int32)
            out.append(self._codec.encode_blocks(blk[None, :])[0])
            pos += bs
        return np.concatenate(out).astype(np.uint8)

    def decode(self, enc, dec_len: int) -> np.ndarray:
        """Decode an encoded byte array back to dec_len bytes."""
        enc = _as_bytes(enc)
        if enc.shape[-1] != self.get_enc_msg_length(dec_len):
            raise ConfigError(
                f"encoded length {enc.shape[-1]} != expected "
                f"{self.get_enc_msg_length(dec_len)}")
        if self._kind == "none":
            return enc.copy()
        if self._kind == "block":
            c = self._codec
            bits = unpack_bits(enc)
            nblocks = -(-8 * dec_len // c.k)
            cw = bits[: nblocks * c.n].reshape(nblocks, c.n)
            data, _ = c.decode_bits(cw)
            return pack_bits(data.reshape(-1)[: 8 * dec_len])
        if self._kind == "conv":
            bits = unpack_bits(enc)[: _enc_bits_conv(self.scheme, dec_len)]
            dec = self._codec.decode_soft(
                bits.astype(np.float32), 8 * dec_len)
            return pack_bits(dec)
        # rs
        c = self._codec
        out = []
        pos = 0
        for bs in self._rs_block_sizes(dec_len):
            blk = enc[pos: pos + bs + c.nroots].astype(np.int32)
            data, _ = c.decode_blocks(blk[None, :])
            out.append(data[0])
            pos += bs + c.nroots
        return np.concatenate(out).astype(np.uint8)

    def decode_soft(self, levels, dec_len: int) -> np.ndarray:
        """Soft-decision decode from per-bit levels in [0,1] (conv schemes,
        on the device; other schemes threshold at 0.5 there and decode the
        hard bits on the host). ``levels`` is a numpy array or a tensor."""
        levels = levels_tensor(levels, self.device)
        if self._kind == "conv":
            lv = levels[: _enc_bits_conv(self.scheme, dec_len)]
            dec = self._codec.decode_soft(lv, 8 * dec_len)
            return pack_bits(dec)
        hard = pack_bits((levels > 0.5).to(torch.uint8).cpu().numpy())
        return self.decode(hard[: self.get_enc_msg_length(dec_len)], dec_len)


def fec_get_enc_msg_length(scheme: FecScheme | str, dec_len: int) -> int:
    """liquid ``fec_get_enc_msg_length`` free function (host only)."""
    return _enc_msg_length(FecScheme(scheme), dec_len)
