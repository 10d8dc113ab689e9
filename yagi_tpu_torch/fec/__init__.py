"""Forward error correction (reference layer: liquid-dsp's fec module).

Port of :mod:`yagi_tpu.fec`: CRC checksums, repetition codes, the Hamming
family, SECDED, Golay(24,12), convolutional codes (ka9q K=7/K=9/K=15
polynomials, plus punctured rates), Reed-Solomon (255,223), a block
interleaver, and the packetizer that composes them. Same names, same bytes.

Where each part runs:

- Packet-rate byte and bit work stays on the host, as a numpy copy of
  yagi_tpu's (which runs it in numpy too): CRC, the block codes, Golay, RS,
  the interleaver's permutations, encoding, and the packetizer's byte
  stages. Byte results are numpy ``uint8``, flags Python ``bool``.
- The Viterbi decoder, which yagi_tpu runs as a ``lax.scan``, runs in torch
  on the object's device, and so do the packetizer's soft levels (the outer
  permutation is a gather there). :class:`ConvCode`,
  :class:`PuncturedConvCode`, the ``conv*`` factories, :class:`Fec` and
  :class:`Packetizer` take ``device`` (the current CUDA device by default;
  :class:`~yagi_tpu_torch.errors.DeviceError` with no card); the host-only
  codecs take none.

Byte-level APIs mirror liquid's (MSB-first bit packing).
"""

from .crc import (
    CrcScheme, crc_generate_key, crc_validate_message, crc_sizeof_key,
    checksum, crc8, crc16, crc24, crc32,
)
from .block import (
    LinearBlockCode, RepetitionCode, hamming74, hamming84, hamming128,
    hamming1511, hamming3126, secded2216, secded3932, secded7264,
    rep3, rep5,
)
from .golay import Golay2412, golay2412
from .conv import ConvCode, PuncturedConvCode, conv27, conv29, conv39, conv615, conv_punctured
from .rs import ReedSolomon, rs8
from .interleave import Interleaver
from .api import Fec, FecScheme, fec_get_enc_msg_length
from .packetizer import Packetizer

__all__ = [
    "CrcScheme", "crc_generate_key", "crc_validate_message", "crc_sizeof_key",
    "checksum", "crc8", "crc16", "crc24", "crc32",
    "LinearBlockCode", "RepetitionCode", "hamming74", "hamming84",
    "hamming128", "hamming1511", "hamming3126", "secded2216", "secded3932",
    "secded7264", "rep3", "rep5",
    "Golay2412", "golay2412",
    "ConvCode", "PuncturedConvCode", "conv27", "conv29", "conv39", "conv615",
    "conv_punctured",
    "ReedSolomon", "rs8",
    "Interleaver",
    "Fec", "FecScheme", "fec_get_enc_msg_length",
    "Packetizer",
]
