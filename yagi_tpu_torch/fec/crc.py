"""Cyclic redundancy checks + 8-bit checksum.

Fills the reference's empty fec module; behavioral spec is liquid-dsp's
crc layer (LIQUID_COMPAT.md:139-170 feature rows): schemes
{checksum, crc8, crc16, crc24, crc32} with key sizes {1,1,2,3,4} bytes,
``crc_generate_key`` / ``crc_validate_message`` byte-message API.

Copied from :mod:`yagi_tpu.fec.crc`. Where it runs: CRC is packet-rate
byte work, so it stays on the host in numpy, as in yagi_tpu; keys are
Python ints and validity a Python bool. Table-driven, one table lookup per
byte. Generator polynomials are the standard ones liquid
uses (CRC-8-ATM 0x07, CRC-16-IBM 0x8005 reflected, CRC-24-Radix 0x5D6DCB,
CRC-32 0x04C11DB7 reflected).
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from ..errors import ConfigError

__all__ = [
    "CrcScheme", "crc_sizeof_key", "crc_generate_key",
    "crc_validate_message", "checksum", "crc8", "crc16", "crc24", "crc32",
]


class CrcScheme(str, Enum):
    NONE = "none"
    CHECKSUM = "checksum"
    CRC8 = "crc8"
    CRC16 = "crc16"
    CRC24 = "crc24"
    CRC32 = "crc32"


def _make_table(poly: int, width: int, reflect: bool) -> np.ndarray:
    """Standard 256-entry CRC table."""
    table = np.zeros(256, dtype=np.uint64)
    topbit = 1 << (width - 1)
    mask = (1 << width) - 1
    for byte in range(256):
        if reflect:
            crc = int("{:08b}".format(byte)[::-1], 2)
        else:
            crc = byte
        crc <<= width - 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & topbit) else (crc << 1)
            crc &= mask
        if reflect:
            crc = int(bin(crc | (1 << width))[3:][::-1], 2)
        table[byte] = crc
    return table


_TAB8 = _make_table(0x07, 8, reflect=False)
_TAB16 = _make_table(0x8005, 16, reflect=True)
_TAB24 = _make_table(0x5D6DCB, 24, reflect=False)
_TAB32 = _make_table(0x04C11DB7, 32, reflect=True)


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def checksum(data) -> int:
    """8-bit two's-complement checksum (liquid ``checksum_generate_key``)."""
    data = _as_bytes(data)
    return int((-int(np.sum(data.astype(np.uint64)))) & 0xFF)


def _crc_forward(data, table: np.ndarray, width: int, init: int,
                 xorout: int) -> int:
    crc = init
    mask = (1 << width) - 1
    for b in _as_bytes(data).ravel():
        crc = ((crc << 8) & mask) ^ int(table[((crc >> (width - 8)) ^ int(b)) & 0xFF])
    return crc ^ xorout


def _crc_reflected(data, table: np.ndarray, width: int, init: int,
                   xorout: int) -> int:
    crc = init
    for b in _as_bytes(data).ravel():
        crc = (crc >> 8) ^ int(table[(crc ^ int(b)) & 0xFF])
    return crc ^ xorout


def crc8(data) -> int:
    return _crc_forward(data, _TAB8, 8, 0x00, 0x00)


def crc16(data) -> int:
    return _crc_reflected(data, _TAB16, 16, 0x0000, 0x0000)


def crc24(data) -> int:
    return _crc_forward(data, _TAB24, 24, 0xB704CE, 0x000000)


def crc32(data) -> int:
    return _crc_reflected(data, _TAB32, 32, 0xFFFFFFFF, 0xFFFFFFFF)


_SIZE = {
    CrcScheme.NONE: 0, CrcScheme.CHECKSUM: 1, CrcScheme.CRC8: 1,
    CrcScheme.CRC16: 2, CrcScheme.CRC24: 3, CrcScheme.CRC32: 4,
}
_FN = {
    CrcScheme.CHECKSUM: checksum, CrcScheme.CRC8: crc8,
    CrcScheme.CRC16: crc16, CrcScheme.CRC24: crc24, CrcScheme.CRC32: crc32,
}


def crc_sizeof_key(scheme: CrcScheme | str) -> int:
    """Key length in bytes (liquid ``crc_sizeof_key``)."""
    scheme = CrcScheme(scheme)
    return _SIZE[scheme]


def crc_generate_key(scheme: CrcScheme | str, data) -> int:
    """Compute the integer key for a byte message (liquid
    ``crc_generate_key``)."""
    scheme = CrcScheme(scheme)
    if scheme == CrcScheme.NONE:
        return 0
    try:
        return _FN[scheme](data)
    except KeyError:  # pragma: no cover
        raise ConfigError(f"unknown CRC scheme {scheme}")


def crc_validate_message(scheme: CrcScheme | str, data, key: int) -> bool:
    """True iff ``key`` matches the message (liquid
    ``crc_validate_message``)."""
    return crc_generate_key(scheme, data) == int(key)
