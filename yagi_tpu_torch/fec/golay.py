"""Extended binary Golay(24,12) code.

Fills the reference's empty fec module; behavioral spec is liquid-dsp's
``fec_golay2412`` (LIQUID_COMPAT.md fec rows): 12 data bits -> 24 coded
bits, corrects any <=3 bit errors, detects 4.

Construction: systematic ``G = [I12 | B]`` with B built from the quadratic
residues of 11 (Paley construction); minimum distance 8 is asserted by
exhaustive enumeration of all 4096 codewords at module init (cheap, done
once). Decoding is table-driven and branch-free: the 12-bit syndrome
indexes a precomputed 4096 x 24 error-pattern table covering every
correctable (weight <= 3) pattern — one gather + XOR per codeword, batched
over blocks.

Copied from :mod:`yagi_tpu.fec.golay`. Where it runs: packet-rate bit
work, on the host in numpy, as in yagi_tpu.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Golay2412", "golay2412"]


def _build_B() -> np.ndarray:
    """Paley-construction B (12x12) from QR(11); validated for d_min = 8."""
    Q = {(i * i) % 11 for i in range(1, 11)}  # {1,3,4,5,9}
    B = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            if i != j and ((i - j) % 11) in Q:
                B[i, j] = 1
        B[i, i] = 1  # diagonal variant; validity checked below
        B[i, 11] = 1
        B[11, i] = 1
    B[11, 11] = 0
    return B


def _min_weight(G: np.ndarray) -> int:
    k, n = G.shape
    msgs = ((np.arange(1, 1 << k)[:, None] >> np.arange(k)) & 1).astype(np.uint8)
    cw = (msgs @ G) % 2
    return int(cw.sum(axis=1).min())


def _find_B() -> np.ndarray:
    Q = {(i * i) % 11 for i in range(1, 11)}
    # try the standard variants (residue/non-residue circulant, with/without
    # diagonal) and keep the one achieving d_min = 8
    for use_residue in (True, False):
        for diag in (0, 1):
            B = np.zeros((12, 12), dtype=np.uint8)
            for i in range(11):
                for j in range(11):
                    if i == j:
                        B[i, j] = diag
                    else:
                        inq = ((i - j) % 11) in Q
                        B[i, j] = 1 if (inq == use_residue) else 0
                B[i, 11] = 1
                B[11, i] = 1
            B[11, 11] = 0
            G = np.concatenate([np.eye(12, dtype=np.uint8), B], axis=1)
            if _min_weight(G) == 8:
                return B
    raise AssertionError("Golay B construction failed")  # pragma: no cover


_B = _find_B()
_G = np.concatenate([np.eye(12, dtype=np.uint8), _B], axis=1)  # [12, 24]
# H = [B^T | I12]; G H^T = B + B = 0 over GF(2)
_H = np.concatenate([_B.T, np.eye(12, dtype=np.uint8)], axis=1)  # [12, 24]
_POW2 = (1 << np.arange(11, -1, -1)).astype(np.int64)


def _build_decode_table():
    """syndrome (12-bit int) -> 24-bit error pattern, for all wt<=3 errors."""
    err = np.zeros((1 << 12, 24), dtype=np.uint8)
    valid = np.zeros(1 << 12, dtype=bool)
    valid[0] = True
    Hc = _H.T.astype(np.int64)  # [24, 12] columns of H as rows
    col_int = Hc @ _POW2  # syndrome of a single-bit error at position i

    def add(pos_list):
        s = 0
        e = np.zeros(24, dtype=np.uint8)
        for p in pos_list:
            s ^= int(col_int[p])
            e[p] = 1
        if not valid[s]:
            err[s] = e
            valid[s] = True

    for a in range(24):
        add([a])
    for a in range(24):
        for b in range(a + 1, 24):
            add([a, b])
    for a in range(24):
        for b in range(a + 1, 24):
            for c in range(b + 1, 24):
                add([a, b, c])
    return err, valid


_ERR_TABLE, _SYN_VALID = _build_decode_table()


class Golay2412:
    """Golay(24,12) codec; batched over leading dims."""

    k = 12
    n = 24
    name = "golay2412"
    rate = 0.5

    def encode_bits(self, bits):
        """[..., 12] -> [..., 24]."""
        bits = np.asarray(bits, dtype=np.uint8) & 1
        return ((bits @ _G) % 2).astype(np.uint8)

    def decode_bits(self, bits):
        """[..., 24] -> (data [..., 12], detected_uncorrectable [...])."""
        bits = np.asarray(bits, dtype=np.uint8) & 1
        syn = (bits @ _H.T) % 2  # [..., 12]
        s_int = syn.astype(np.int64) @ _POW2
        e = _ERR_TABLE[s_int]  # [..., 24]
        corrected = bits ^ e
        detected = ~_SYN_VALID[s_int]
        return corrected[..., :12], detected


def golay2412() -> Golay2412:
    return Golay2412()
