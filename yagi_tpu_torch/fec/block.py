"""Linear block codes over GF(2): Hamming family, SECDED, repetition.

Fills the reference's empty fec module; behavioral spec is liquid-dsp's
block-code set (LIQUID_COMPAT.md:171-300 feature rows):
hamming74, hamming84 (extended), hamming128 = (12,8), hamming1511,
hamming3126, secded2216, secded3932, secded7264, rep3, rep5.

Copied from :mod:`yagi_tpu.fec.block`. Where it runs: block coding is
packet-rate bit work, so it stays on the host in numpy, as in yagi_tpu. A
codeword batch is a bit matrix ``[blocks, k]``; encode is ``bits @ G % 2``
and the syndrome ``bits @ H.T % 2``; decode is branch-free (syndrome ->
error-position lookup -> one-hot XOR) over any number of blocks.

All shortened/extended members are generated from one parametric
construction (full Hamming H with weight>=2 data columns, shortened from
the front, optionally extended with an overall parity bit), which is the
textbook construction liquid's hand-written codecs implement.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = [
    "LinearBlockCode", "RepetitionCode",
    "hamming74", "hamming84", "hamming128", "hamming1511", "hamming3126",
    "secded2216", "secded3932", "secded7264", "rep3", "rep5",
]


def _hamming_data_columns(r: int) -> np.ndarray:
    """All r-bit column vectors of weight >= 2, ascending — the data-bit
    columns of a systematic Hamming parity-check matrix. Shape [k_full, r]."""
    cols = []
    for v in range(3, 1 << r):
        if bin(v).count("1") >= 2:
            cols.append([(v >> (r - 1 - i)) & 1 for i in range(r)])
    return np.array(cols, dtype=np.uint8)


class LinearBlockCode:
    """Systematic (n, k) single-error-correcting code, optionally extended
    with an overall parity bit for double-error detection (SECDED).

    encode: ``c = [d | d @ P | (parity)]``; decode: branch-free syndrome
    lookup + one-hot correction. Batched over leading dims.
    """

    def __init__(self, r: int, k: int, extended: bool, name: str):
        full = _hamming_data_columns(r)
        if not 1 <= k <= full.shape[0]:
            raise ConfigError(f"k ({k}) invalid for r={r}")
        # shorten from the front (drop highest columns) -> keep last k
        self.P = full[full.shape[0] - k:]          # [k, r]
        self.r = r
        self.k = k
        self.extended = extended
        self.name = name
        self.n = k + r + (1 if extended else 0)
        # H for the base (non-extended) part: columns = data cols then I_r
        Hcols = np.concatenate([self.P, np.eye(r, dtype=np.uint8)], axis=0)  # [k+r, r]
        pow2 = 1 << np.arange(r - 1, -1, -1)
        col_ids = (Hcols.astype(np.int64) * pow2).sum(axis=1)  # [k+r]
        # syndrome int -> error position in the base codeword; k+r = "none"
        lut = np.full(1 << r, k + r, dtype=np.int32)
        lut[col_ids] = np.arange(k + r)
        lut[0] = k + r
        self._pos_lut = lut
        self._pow2 = pow2.astype(np.int32)
        self.rate = k / self.n

    def encode_bits(self, bits):
        """[..., k] data bits -> [..., n] codeword bits."""
        bits = np.asarray(bits, dtype=np.uint8) & 1
        par = (bits @ self.P) % 2  # [..., r]
        cw = np.concatenate([bits, par], axis=-1)
        if self.extended:
            overall = cw.sum(axis=-1, keepdims=True) % 2
            cw = np.concatenate([cw, overall], axis=-1)
        return cw.astype(np.uint8)

    def decode_bits(self, bits):
        """[..., n] received bits -> (data [..., k], detected_uncorrectable
        [...] bool). Branch-free syndrome decode."""
        bits = np.asarray(bits, dtype=np.uint8) & 1
        base = bits[..., : self.k + self.r]
        syn = (base[..., : self.k] @ self.P + base[..., self.k:]) % 2  # [..., r]
        s_int = (syn.astype(np.int32) @ self._pow2)  # [...]
        pos = self._pos_lut[s_int]  # [...] in [0, k+r]
        if self.extended:
            overall = bits.sum(axis=-1) % 2  # parity of whole word
            # odd parity -> odd # errors: correct as single error
            correct = overall == 1
            # even parity with nonzero syndrome -> >=2 errors: detect only
            detected = (overall == 0) & (s_int != 0)
            pos = np.where(correct, pos, self.k + self.r)
        else:
            detected = pos == self.k + self.r
            detected &= s_int != 0
        flip = (np.arange(self.k + self.r) == pos[..., None]).astype(np.uint8)
        corrected = base ^ flip
        return corrected[..., : self.k], detected


class RepetitionCode:
    """rep-R majority-vote code (liquid rep3/rep5)."""

    def __init__(self, reps: int):
        if reps < 3 or reps % 2 == 0:
            raise ConfigError(f"reps ({reps}) must be odd and >= 3")
        self.reps = reps
        self.k = 1
        self.n = reps
        self.name = f"rep{reps}"
        self.rate = 1.0 / reps

    def encode_bits(self, bits):
        """[..., k] -> [..., k*reps]: bitwise repetition (liquid repeats the
        whole message block, equivalent under the interleaved layout)."""
        bits = np.asarray(bits, dtype=np.uint8) & 1
        return np.repeat(bits, self.reps, axis=-1)

    def decode_bits(self, bits):
        bits = np.asarray(bits, dtype=np.uint8) & 1
        shape = bits.shape[:-1] + (bits.shape[-1] // self.reps, self.reps)
        votes = bits.reshape(shape).sum(axis=-1)
        out = (votes > self.reps // 2).astype(np.uint8)
        detected = (votes != 0) & (votes != self.reps)
        return out, detected.any(axis=-1)


def hamming74() -> LinearBlockCode:
    return LinearBlockCode(r=3, k=4, extended=False, name="hamming74")


def hamming84() -> LinearBlockCode:
    return LinearBlockCode(r=3, k=4, extended=True, name="hamming84")


def hamming128() -> LinearBlockCode:
    """(12,8) shortened Hamming (liquid hamming128)."""
    return LinearBlockCode(r=4, k=8, extended=False, name="hamming128")


def hamming1511() -> LinearBlockCode:
    return LinearBlockCode(r=4, k=11, extended=False, name="hamming1511")


def hamming3126() -> LinearBlockCode:
    return LinearBlockCode(r=5, k=26, extended=False, name="hamming3126")


def secded2216() -> LinearBlockCode:
    """(22,16) shortened extended Hamming SECDED (liquid secded2216)."""
    return LinearBlockCode(r=5, k=16, extended=True, name="secded2216")


def secded3932() -> LinearBlockCode:
    return LinearBlockCode(r=6, k=32, extended=True, name="secded3932")


def secded7264() -> LinearBlockCode:
    return LinearBlockCode(r=7, k=64, extended=True, name="secded7264")


def rep3() -> RepetitionCode:
    return RepetitionCode(3)


def rep5() -> RepetitionCode:
    return RepetitionCode(5)
