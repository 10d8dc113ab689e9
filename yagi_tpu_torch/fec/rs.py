"""Reed-Solomon over GF(256) — liquid's ``rs8`` = RS(255,223).

Fills the reference's empty fec module; behavioral spec is liquid-dsp's
``fec_rs8`` (ka9q libfec CCSDS parameters: field polynomial 0x187,
first consecutive root fcr=112, primitive element alpha^11, 32 parity
symbols, t=16 correctable symbol errors). Shortened blocks are handled by
implicit leading zero padding, as in libfec's ``encode_rs_char`` with pad.

RS is a packet-rate operation: the implementation is vectorized numpy on
host (GF(256) log/antilog tables; syndrome evaluation and Chien search are
batched matrix-style table gathers over all blocks at once; only the
Berlekamp-Massey recursion — 32 tiny steps — loops per block).

Copied from :mod:`yagi_tpu.fec.rs`. Where it runs: on the host in numpy,
as in yagi_tpu.
"""

from __future__ import annotations

import numpy as np

from ..errors import ConfigError

__all__ = ["ReedSolomon", "rs8"]


class _GF256:
    def __init__(self, poly: int):
        exp = np.zeros(512, dtype=np.int32)
        log = np.zeros(256, dtype=np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= poly
        exp[255:510] = exp[0:255]
        self.exp, self.log = exp, log

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.exp[(self.log[a] + self.log[b]) % 255]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int32)
        return self.exp[(255 - self.log[a]) % 255]

    def pow_alpha(self, e):
        return int(self.exp[int(e) % 255])


class ReedSolomon:
    """RS(n=255, k=255-nroots) codec with configurable ka9q parameters."""

    def __init__(self, nroots: int = 32, poly: int = 0x187, fcr: int = 112,
                 prim: int = 11, name: str = "rs8"):
        if not 2 <= nroots <= 64:
            raise ConfigError(f"nroots ({nroots}) out of range")
        self.gf = _GF256(poly)
        self.nroots = nroots
        self.fcr = fcr
        self.prim = prim
        self.n = 255
        self.k = 255 - nroots
        self.t = nroots // 2
        self.name = name
        self.rate = self.k / self.n
        # iprim: multiplicative inverse of prim mod 255 (maps root index ->
        # error location exponent, as in libfec)
        self.iprim = pow(prim, -1, 255)
        # generator polynomial g(x) = prod_{i} (x - alpha^{prim*(fcr+i)})
        g = np.zeros(nroots + 1, dtype=np.int32)
        g[0] = 1
        for i in range(nroots):
            root = self.gf.pow_alpha(prim * (fcr + i))
            ng = np.zeros(nroots + 1, dtype=np.int32)
            ng[1:] ^= g[:-1]
            ng ^= self.gf.mul(g, root)
            g = ng
        self.genpoly = g  # ascending-power order? stored highest-first below
        # precompute syndrome evaluation matrix powers lazily per length

    # ---------------- encode ----------------

    def encode_blocks(self, data: np.ndarray) -> np.ndarray:
        """[B, k'] (k' <= k, shortened) -> [B, k'+nroots] systematic
        codewords. LFSR polynomial division, vectorized across blocks."""
        data = np.atleast_2d(np.asarray(data, dtype=np.int32))
        B, kk = data.shape
        if kk > self.k:
            raise ConfigError(f"block length {kk} > k ({self.k})")
        nr = self.nroots
        g = self.genpoly  # g[0]=leading... g constructed with g[0]=x^nroots coeff? see below
        # genpoly above: g[j] is coefficient of x^{nroots-j}? We built by
        # convolution with ng[1:] ^= g[:-1] (multiply by x) and ng ^= g*root,
        # starting g=[1,0..] => g[0] is the x^deg coefficient, g[-1] constant.
        par = np.zeros((B, nr), dtype=np.int32)
        for j in range(kk):
            fb = data[:, j] ^ par[:, 0]
            # par = (par shifted left) + fb * g[1:]
            shifted = np.concatenate(
                [par[:, 1:], np.zeros((B, 1), np.int32)], axis=1)
            par = shifted ^ self.gf.mul(fb[:, None], g[None, 1:])
        return np.concatenate([data, par], axis=1)

    # ---------------- decode ----------------

    def decode_blocks(self, recv: np.ndarray):
        """[B, k'+nroots] -> (data [B, k'], fail [B] bool). Corrects up to
        t = nroots/2 symbol errors per block."""
        recv = np.atleast_2d(np.asarray(recv, dtype=np.int32))
        B, L = recv.shape
        nr = self.nroots
        kk = L - nr
        if kk < 1:
            raise ConfigError("block too short")
        pad = self.n - L
        gf = self.gf
        # syndromes S_i = r(alpha^{prim*(fcr+i)}), i=0..nr-1, via Horner
        # vectorized: S = sum_j r_j * alpha^{prim*(fcr+i)*(L-1-j+pad? )}
        # Positions: codeword poly r(x) = sum_j recv[j] x^{n-1-pad-j}
        degs = (self.n - 1 - pad - np.arange(L)) % 255  # [L]
        roots_e = (self.prim * (self.fcr + np.arange(nr))) % 255  # [nr]
        expo = (degs[None, :] * roots_e[:, None]) % 255  # [nr, L]
        xpow = gf.exp[expo]  # [nr, L]
        nz = recv != 0
        logr = gf.log[recv]  # [B, L]
        terms = np.where(
            nz[:, None, :],
            gf.exp[(logr[:, None, :] + gf.log[xpow][None, :, :]) % 255],
            0,
        )  # [B, nr, L]
        S = np.bitwise_xor.reduce(terms, axis=2)  # [B, nr]
        fail = np.zeros(B, dtype=bool)
        out = recv.copy()
        for b in range(B):
            if not S[b].any():
                continue
            ok = self._correct(out[b], S[b], pad)
            fail[b] = not ok
        return out[:, :kk], fail

    def _correct(self, r: np.ndarray, S: np.ndarray, pad: int) -> bool:
        gf = self.gf
        nr = self.nroots
        # Berlekamp-Massey
        C = np.zeros(nr + 1, dtype=np.int32); C[0] = 1
        Bp = np.zeros(nr + 1, dtype=np.int32); Bp[0] = 1
        Lc, m, bdisc = 0, 1, 1
        for n_i in range(nr):
            d = S[n_i]
            for i in range(1, Lc + 1):
                d ^= int(gf.mul(C[i], S[n_i - i]))
            if d == 0:
                m += 1
            elif 2 * Lc <= n_i:
                T = C.copy()
                coef = gf.mul(d, gf.inv(bdisc))
                C[m:] ^= gf.mul(coef, Bp[: nr + 1 - m])
                Lc = n_i + 1 - Lc
                Bp = T
                bdisc = int(d)
                m = 1
            else:
                coef = gf.mul(d, gf.inv(bdisc))
                C[m:] ^= gf.mul(coef, Bp[: nr + 1 - m])
                m += 1
        if Lc > self.t:
            return False
        # Chien search over valid positions (deg exponents of actual symbols)
        L = r.shape[0]
        degs = (self.n - 1 - pad - np.arange(L)) % 255  # X_j = alpha^{prim*degs? }
        # error locator roots: Lambda(X^-1)=0 where X = alpha^{prim*pos}
        # evaluate Lambda at x = alpha^{-prim*deg} for each position
        ii = np.arange(Lc + 1)
        lam_nz = C[: Lc + 1] != 0
        loglam = gf.log[C[: Lc + 1]]
        xe = (-self.prim * degs[:, None] * ii[None, :]) % 255  # [L, Lc+1]
        terms = np.where(lam_nz[None, :], gf.exp[(loglam[None, :] + xe) % 255], 0)
        lam_eval = np.bitwise_xor.reduce(terms, axis=1)  # [L]
        err_pos = np.nonzero(lam_eval == 0)[0]
        if err_pos.shape[0] != Lc:
            return False
        # Forney: Omega(x) = [S(x) Lambda(x)] mod x^nr
        Sx = S.astype(np.int32)
        Om = np.zeros(nr, dtype=np.int32)
        for i in range(nr):
            acc = 0
            for j in range(min(i + 1, Lc + 1)):
                acc ^= int(gf.mul(C[j], Sx[i - j]))
            Om[i] = acc
        for pos in err_pos:
            Xinv_e = (-self.prim * int(degs[pos])) % 255  # alpha^{-prim*deg}
            # Omega(Xinv)
            om = 0
            for i in range(nr):
                if Om[i]:
                    om ^= int(gf.exp[(gf.log[Om[i]] + i * Xinv_e) % 255])
            # Lambda'(Xinv): derivative = sum over odd i of C[i] x^{i-1}
            lp = 0
            for i in range(1, Lc + 1, 2):
                if C[i]:
                    lp ^= int(gf.exp[(gf.log[C[i]] + (i - 1) * Xinv_e) % 255])
            if lp == 0:
                return False
            mag = gf.mul(om, gf.inv(lp))
            # error magnitude scaling: e = X^{1-fcr} * Omega/Lambda'
            X_e = (self.prim * int(degs[pos])) % 255
            scale = gf.exp[((1 - self.fcr) * X_e) % 255]
            e = int(gf.mul(mag, scale))
            r[pos] ^= e
        return True


def rs8() -> ReedSolomon:
    """liquid fec_rs8: CCSDS RS(255,223) via ka9q parameters."""
    return ReedSolomon(nroots=32, poly=0x187, fcr=112, prim=11, name="rs8")
