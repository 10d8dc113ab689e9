"""OFDM frame generator and synchronizer.

Port of :mod:`yagi_tpu.multichannel.ofdm` (liquid-dsp's ofdmframegen /
ofdmframesync, LIQUID_COMPAT.md:1801-1810): M subcarriers typed {null,
pilot, data}, a cyclic prefix, an S0 short-sync symbol (periodic halves:
the Schmidl-Cox timing metric and fractional CFO) and an S1 long-sync
symbol (cross-correlation: fine timing and the channel estimate), then data
symbols with per-symbol pilot phase tracking and one-tap frequency-domain
equalization.

yagi_tpu runs this on the host in numpy complex128; the port runs it in
torch complex128 on the object's device (the H100 has fp64): the whole
frame as a [num_symbols, M] batch, one batched FFT, one equalizer multiply
and a closed-form weighted least-squares pilot phase fit per symbol (over
the pilots' angles about their weighted circular mean: yagi_tpu fits their
raw angles, ``multichannel/ofdm.py:213``, and loses a symbol whose common
phase sits at ±π; elsewhere the two agree to float rounding). The
geometry (subcarrier map, the ±1 sequences of the sync symbols and pilots,
drawn with numpy's ``default_rng`` as in yagi_tpu) is built on the host once.
Detection has data-dependent control flow: the timing metric, the fine
timing peak and the statistics each come to the host once per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError

__all__ = ["OfdmFrame", "OfdmFrameGen", "OfdmFrameSync", "default_sctype"]

NULL, PILOT, DATA = 0, 1, 2


def default_sctype(M: int) -> np.ndarray:
    """Default subcarrier allocation (liquid
    ``ofdmframe_init_default_sctype``): ~6% guard bands each side, DC null,
    pilots every 7th active subcarrier."""
    if M < 8:
        raise ConfigError(f"number of subcarriers M ({M}) must be >= 8")
    p = np.full(M, DATA, dtype=np.int32)
    guard = max(1, M // 16)
    # FFT-ordered: index 0 = DC, 1..M/2 positive, M/2..M-1 negative
    p[0] = NULL
    p[M // 2 - guard: M // 2 + guard + 1] = NULL
    active = np.nonzero(p == DATA)[0]
    p[active[::7]] = PILOT
    return p


def _validate_sctype(p: np.ndarray):
    n_pilot = int(np.sum(p == PILOT))
    n_data = int(np.sum(p == DATA))
    if n_pilot < 2:
        raise ConfigError(f"subcarrier allocation needs >= 2 pilots (got {n_pilot})")
    if n_data < 1:
        raise ConfigError("subcarrier allocation needs >= 1 data subcarrier")


def _pn_sequence(n: int, seed: int) -> np.ndarray:
    """Deterministic ±1 sequence for the sync symbols and pilots."""
    rng = np.random.default_rng(seed)
    return (1.0 - 2.0 * rng.integers(0, 2, n)).astype(np.float64)


def _centered(k: torch.Tensor, M: int) -> torch.Tensor:
    k = k.to(torch.float64)
    return torch.where(k > M / 2, k - M, k)


class OfdmFrame:
    """Shared frame geometry: subcarrier map, sync symbols, pilots, on
    ``device`` (the card unless the caller asks)."""

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None, device=None):
        self.device = resolve_device(device)
        if M < 8:
            raise ConfigError(f"number of subcarriers M ({M}) must be >= 8")
        if not 0 <= cp_len <= M:
            raise ConfigError(f"cyclic prefix length ({cp_len}) not in [0,M]")
        self.M = M
        self.cp_len = cp_len
        self.p = (np.asarray(sctype, dtype=np.int32) if sctype is not None
                  else default_sctype(M))
        if self.p.size != M:
            raise ConfigError(f"subcarrier map length {self.p.size} != M ({M})")
        _validate_sctype(self.p)
        self.i_pilot = np.nonzero(self.p == PILOT)[0]
        self.i_data = np.nonzero(self.p == DATA)[0]
        self.n_data = self.i_data.size
        dev = dict(dtype=torch.complex128, device=self.device)
        # S0: energy only on even active subcarriers, so periodic in time
        # with period M/2 (Schmidl-Cox structure)
        act = np.nonzero(self.p != NULL)[0]
        act_even = act[act % 2 == 0]
        s0f = np.zeros(M, dtype=np.complex128)
        s0f[act_even] = _pn_sequence(act_even.size, seed=11)
        s0f *= np.sqrt(2.0)  # unit average power in time
        self.S0f = torch.from_numpy(s0f).to(**dev)
        self.s0t = torch.fft.ifft(self.S0f) * np.sqrt(M)
        # S1: all active subcarriers
        s1f = np.zeros(M, dtype=np.complex128)
        s1f[act] = _pn_sequence(act.size, seed=13)
        self.S1f = torch.from_numpy(s1f).to(**dev)
        self.s1t = torch.fft.ifft(self.S1f) * np.sqrt(M)
        # pilot base values
        self.pilots = torch.from_numpy(_pn_sequence(self.i_pilot.size, seed=17)).to(
            torch.float64).to(self.device)
        self.sym_len = M + cp_len
        self._act = torch.from_numpy(self.p != NULL).to(self.device)
        self._i_pilot = torch.from_numpy(self.i_pilot).to(self.device)
        self._i_data = torch.from_numpy(self.i_data).to(self.device)

    def _add_cp(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., -self.cp_len:], x], -1) if self.cp_len else x


class OfdmFrameGen(OfdmFrame):
    """OFDM frame generator (liquid ``ofdmframegen``)."""

    def write_preamble(self) -> torch.Tensor:
        """Two S0 symbols and one S1 symbol, each with its CP, complex64."""
        return torch.cat([self._add_cp(self.s0t), self._add_cp(self.s0t),
                          self._add_cp(self.s1t)]).to(torch.complex64)

    def write_symbols(self, data_symbols) -> torch.Tensor:
        """Data subcarrier values [num_syms, n_data] → time samples
        [num_syms·(M+cp)], complex64; pilots and nulls inserted; one batched
        IFFT."""
        d = torch.as_tensor(np.asarray(data_symbols) if not isinstance(
            data_symbols, torch.Tensor) else data_symbols).to(self.device, torch.complex128)
        d = d.reshape(1, -1) if d.dim() < 2 else d
        if d.shape[-1] != self.n_data:
            raise ConfigError(f"data width {d.shape[-1]} != number of data subcarriers "
                              f"({self.n_data})")
        X = torch.zeros(d.shape[:-1] + (self.M,), dtype=torch.complex128, device=self.device)
        X[..., self._i_data] = d
        X[..., self._i_pilot] = self.pilots.to(torch.complex128)
        x = torch.fft.ifft(X, dim=-1) * np.sqrt(self.M)
        return self._add_cp(x).reshape(-1).to(torch.complex64)

    def assemble(self, data_symbols) -> torch.Tensor:
        """The full frame: preamble + payload symbols."""
        return torch.cat([self.write_preamble(), self.write_symbols(data_symbols)])


class OfdmFrameSync(OfdmFrame):
    """OFDM frame synchronizer (liquid ``ofdmframesync``).

    ``execute(x, num_symbols)`` returns None (no detection) or a dict:
    ``symbols`` [num_symbols, n_data] equalized data subcarriers (complex64,
    on the device), ``stats`` {tau, cfo, rssi_db, evm_pilots_db, rxy}.
    """

    def __init__(self, M: int = 64, cp_len: int = 16, sctype=None, threshold: float = 0.6,
                 device=None):
        super().__init__(M, cp_len, sctype, device)
        if not 0.0 < threshold < 1.0:
            raise ConfigError(f"threshold ({threshold}) must be in (0,1)")
        self.threshold = threshold

    def execute(self, x, num_symbols: int):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        x = x.to(self.device, torch.complex128).reshape(-1)
        M, cp, half = self.M, self.cp_len, self.M // 2
        N = x.shape[0]
        need = 3 * self.sym_len + num_symbols * self.sym_len
        if N < need:
            raise ConfigError(f"buffer ({N}) shorter than frame ({need})")
        # --- Schmidl-Cox metric over the S0 region: window sums of half ---
        c = x[:-half] * x[half:].conj()
        P = c.unfold(0, half, 1).sum(-1)  # correlation of the halves
        E = x.abs().square().unfold(0, half, 1).sum(-1)
        R = P.abs() / (0.5 * (E[:-half] + E[half:]) + 1e-20)
        R_host = R.cpu().numpy()  # one transfer: the detection is host control flow
        cand = np.nonzero(R_host > self.threshold)[0]
        if cand.size == 0:
            return None
        # the plateau: the first run of above-threshold samples, and its
        # best metric point for the fractional CFO
        gaps = np.nonzero(np.diff(cand) != 1)[0]
        run = cand[: gaps[0] + 1] if gaps.size else cand
        d0 = int(run[np.argmax(R_host[run])])
        cfo = -torch.angle(P[d0]) / half  # rad/sample
        n = torch.arange(N, dtype=torch.float64, device=self.device)
        y = x * torch.polar(torch.ones_like(n), -cfo * n)
        # --- fine timing: cross-correlate with the known s1t near the
        # coarse position (S1 follows two S0 symbols) ---
        approx = d0 + 2 * self.sym_len + cp  # rough S1 body start
        lo = max(0, approx - self.sym_len)
        hi = min(N - M, approx + self.sym_len)
        corr = y[lo: hi + M].unfold(0, M, 1) @ self.s1t.conj()
        pk = int(torch.argmax(corr.abs()))
        s1_start = lo + pk
        rxy = corr[pk].abs() / (torch.sqrt(self.s1t.abs().square().sum()
                                           * y[s1_start: s1_start + M].abs().square().sum())
                                + 1e-20)
        # --- channel estimate from S1 ---
        Y1 = torch.fft.fft(y[s1_start: s1_start + M]) / np.sqrt(M)
        G = torch.where(self._act, Y1 / torch.where(self._act, self.S1f, 1.0), 1.0 + 0j)
        # --- payload: one batched FFT over all data symbols ---
        start = s1_start + M  # end of the S1 body
        if start + num_symbols * self.sym_len > N:
            return None
        blocks = y[start: start + num_symbols * self.sym_len].reshape(
            num_symbols, self.sym_len)[:, cp:]  # [ns, M]
        Zd = torch.fft.fft(blocks, dim=-1) / np.sqrt(M) / (G + 1e-12)
        # --- pilot phase tracking: weighted LSQ line across the pilot
        # subcarriers per symbol (residual timing slope + common phase),
        # fitted to each pilot's angle about the symbol's weighted circular
        # mean c, so that a common phase near ±π does not wrap the pilots
        # apart (yagi_tpu fits the raw angles and loses such a symbol) ---
        prx = Zd[:, self._i_pilot] * self.pilots
        k_p = _centered(self._i_pilot, M)
        w = prx.abs()
        c = torch.angle((w * prx).sum(1, keepdim=True))
        ang = c + torch.angle(prx * torch.polar(torch.ones_like(c), -c))  # [ns, n_pilot]
        W = w.sum(1)
        Sk = (w * k_p).sum(1)
        Skk = (w * k_p * k_p).sum(1)
        Sa = (w * ang).sum(1)
        Ska = (w * k_p * ang).sum(1)
        det = Skk * W - Sk * Sk
        slope = torch.where(det.abs() > 1e-12, (Ska * W - Sk * Sa) / det, 0.0)
        const = torch.where(W > 1e-12, (Sa - slope * Sk) / torch.clamp(W, min=1e-12), 0.0)
        k_d = _centered(self._i_data, M)
        ph = const[:, None] + slope[:, None] * k_d
        symbols = (Zd[:, self._i_data] * torch.polar(torch.ones_like(ph), -ph)).to(
            torch.complex64)
        # pilot EVM after the correction
        php = const[:, None] + slope[:, None] * k_p
        perr = Zd[:, self._i_pilot] * torch.polar(torch.ones_like(php), -php) - self.pilots
        evm = 10.0 * torch.log10(perr.abs().square().mean() + 1e-20)
        rssi = 10.0 * torch.log10(blocks.abs().square().mean() + 1e-20)
        cfo_h, rssi_h, evm_h, rxy_h = torch.stack([cfo, rssi, evm, rxy]).tolist()
        if rxy_h < self.threshold:
            return None
        return {
            "symbols": symbols,
            "stats": {
                "tau": float(s1_start - 2 * self.sym_len - cp),
                "cfo": cfo_h,
                "rssi_db": rssi_h,
                "evm_pilots_db": evm_h,
                "rxy": rxy_h,
            },
        }
