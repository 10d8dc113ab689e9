"""Polyphase filter bank channelizer (analysis / synthesis).

Port of :class:`yagi_tpu.multichannel.firpfbch.Firpfbch`, the liquid-dsp
firpfbch algorithm: commutator → per-branch FIR → M-point (I)FFT. It is the
plain, unfused oracle of :class:`FusedChannelizer` (BASELINE config[4]).

Analysis math (critically sampled, M channels, decimation M): channel k at
output step n equals mix-down by k/M → lowpass h → keep every M-th sample:
  y_k[n] = Σ_j h[j]·x[nM-j]·e^{+j2πkj/M}
         = Σ_b e^{+j2πkb/M} · u_b[n],   u_b[n] = Σ_p h[b+pM]·x[(n-p)M-b]
i.e. branch b FIR-filters the delayed decimated stream s_b[i] = x[iM-b], and
an unnormalized inverse DFT across branches yields the channels.

Synthesis is the dual: unnormalized IDFT across channels → branch FIRs →
commutate into the output stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .. import design
from .._src.device import resolve_device
from .._src.window import carry
from ..errors import ConfigError
from ..filter.firpfb import pfb_decompose

__all__ = ["Firpfbch", "Firpfbch2"]


def _grouped_branch_conv(xb: torch.Tensor, branches: torch.Tensor) -> torch.Tensor:
    """Per-branch causal FIR: xb [..., M, N+p-1] (left context included),
    branches [M, p] in conv order → [..., M, N], as p shifted multiply-adds."""
    M, p = branches.shape
    n = xb.shape[-1] - (p - 1)
    acc = None
    for j in range(p):
        # tap j multiplies the sample j steps back: s[b, i-j] = xb[b, p-1+i-j]
        term = branches[:, j, None] * xb[..., p - 1 - j : p - 1 - j + n]
        acc = term if acc is None else acc + term
    return acc


def _idft_matrix(M: int) -> np.ndarray:
    """Unnormalized inverse-DFT matrix W[b, k] = exp(+2πi·bk/M)/M."""
    b = np.arange(M)
    return np.exp(2j * np.pi * np.outer(b, b) / M).astype(np.complex64) / M


def _idft(u: torch.Tensor) -> torch.Tensor:
    """IDFT over axis -2 of [..., M, N]: an fp32 complex matmul up to 128
    channels (full fp32 on the card only with TF32 off), torch.fft.ifft
    beyond."""
    M = u.shape[-2]
    if M <= 128:
        w = torch.from_numpy(_idft_matrix(M)).to(u.device)
        return w.T @ u
    return torch.fft.ifft(u, dim=-2)


def _sliding_residue_conv(xa: torch.Tensor, branches: torch.Tensor, P: int) -> torch.Tensor:
    """c_r[t] = Σ_q h[r+qM]·xa[e_t − r − qM] for every step t and residue
    r, with e_t = (L−2) + (t+1)·P and L = p·M: [..., T, M].

    The sliding-transform channelizers' (Firpfbch2, Firpfbchr) branch sums.
    The window ending at e_t is a strided view of ``xa`` (no gather);
    reversed and viewed as [p, M], residue r's samples x[e_t − r − qM] are
    its column r, so a step costs the p·M taps once.
    """
    M, p = branches.shape
    frames = xa[..., P - 1 :].unfold(-1, p * M, P)  # [..., T, L], frame t ends at e_t
    rev = frames.flip(-1).reshape(frames.shape[:-1] + (p, M))  # [..., T, q, r]
    return (rev * branches.T).sum(dim=-2)


def _twiddle(M: int, e: torch.Tensor) -> torch.Tensor:
    """[T, M] e^{-j2πk·e_t/M}: the root of unity of (k·e_t) mod M, so the
    phase is exact for any global sample index e_t (int64)."""
    roots = np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)
    k = torch.arange(M, device=e.device)
    return torch.from_numpy(roots).to(e.device)[(k[None, :] * e[:, None]) % M]


def _design_prototype(num_channels: int, m: int, as_: float) -> np.ndarray:
    h_len = 2 * num_channels * m + 1
    h = design.fir_design_kaiser(h_len, 0.5 / num_channels, as_, 0.0)
    return h[: h_len - 1]  # length 2·M·m


@struct.state
class Firpfbch:
    """Critically-sampled M-channel analysis/synthesis bank.

    State: per-branch stream history [..., M, p-1] plus the raw M-1 input
    tail (needed to form cross-block branch samples x[iM-b]).
    """

    num_channels: int = struct.static_field()
    branches: torch.Tensor = struct.field()  # [M, p] conv order, float32
    scale: torch.Tensor = struct.field()  # float32 scalar
    window: torch.Tensor = struct.field()  # [..., M, p-1] complex64
    raw_tail: torch.Tensor = struct.field()  # [..., M-1] complex64

    # ------------------------------------------------------------------ ctors
    @classmethod
    def create(cls, num_channels: int, h, batch_shape: tuple = (), device=None) -> "Firpfbch":
        device = resolve_device(device)
        if num_channels < 2:
            raise ConfigError("number of channels must be at least 2")
        M = num_channels
        branches = pfb_decompose(np.asarray(h), M)  # [M, p], branches[b,p]=h[b+pM]
        p = branches.shape[1]
        return cls(
            num_channels=M,
            branches=torch.from_numpy(branches.astype(np.float32)).to(device),
            scale=torch.tensor(1.0, dtype=torch.float32, device=device),
            window=torch.zeros(batch_shape + (M, p - 1), dtype=torch.complex64, device=device),
            raw_tail=torch.zeros(batch_shape + (M - 1,), dtype=torch.complex64, device=device),
        )

    @classmethod
    def create_kaiser(cls, num_channels: int, m: int = 4, as_: float = 60.0, **kw) -> "Firpfbch":
        """Kaiser prototype at fc = 0.5/M (liquid firpfbch kaiser ctor)."""
        if m < 1:
            raise ConfigError("filter semi-length must be at least 1")
        return cls.create(num_channels, _design_prototype(num_channels, m, as_), **kw)

    @classmethod
    def create_rnyquist(cls, ftype, num_channels: int, m: int, beta: float, **kw) -> "Firpfbch":
        """Root-Nyquist prototype (liquid firpfbch rnyquist ctor): ``ftype``
        one of the shapes :func:`design.fir_design_prototype` ports (KAISER,
        RCOS, RRCOS)."""
        h = design.fir_design_prototype(ftype, num_channels, m, beta, 0.0)
        return cls.create(num_channels, h[: 2 * num_channels * m], **kw)

    # ------------------------------------------------------------ properties
    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def get_delay(self) -> int:
        """Group delay in output steps ≈ p/2."""
        return self.p // 2

    def reset(self) -> "Firpfbch":
        return self.replace(
            window=torch.zeros_like(self.window),
            raw_tail=torch.zeros_like(self.raw_tail),
        )

    def set_scale(self, scale) -> "Firpfbch":
        return self.replace(
            scale=torch.tensor(float(scale), dtype=torch.float32, device=self.branches.device)
        )

    # ------------------------------------------------------------- analysis
    def analyzer_execute(self, x) -> tuple[torch.Tensor, "Firpfbch"]:
        """x [..., N·M] → channels [..., M, N]; channel k centered at +k/M."""
        x = torch.as_tensor(x, dtype=torch.complex64, device=self.branches.device)
        total = x.shape[-1]
        M = self.num_channels
        if total % M:
            raise ConfigError(f"input length must be a multiple of M={M}")
        n = total // M

        # branch streams s_b[i] = x[iM - b]: prepend one history block,
        # reshape to M-sample blocks, lane-reverse, shift one block. xfull
        # block i, lane c = x[(i-1)M + c], so reversed lanes give
        # xrev[i, j] = x[iM - 1 - j] ⇒ s_b[i] = xrev[i, b-1] (b ≥ 1) and
        # s_0[i] = x[iM] = block i+1, lane 0.
        lead = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        xf = torch.cat([lead, self.raw_tail, x], dim=-1).reshape(x.shape[:-1] + (n + 1, M))
        s0 = xf[..., 1:, 0:1]  # [..., n, 1]
        s_rest = xf.flip(-1)[..., :n, : M - 1]  # [..., n, M-1]
        s = torch.cat([s0, s_rest], dim=-1).transpose(-1, -2)
        # the last M-1 samples of [raw_tail | x], without copying all of x
        xa = torch.cat([self.raw_tail, x[..., max(total - (M - 1), 0) :]], dim=-1)

        xb = torch.cat([self.window, s], dim=-1)
        u = _grouped_branch_conv(xb, self.branches)  # [..., M, n]
        y = _idft(u) * (M * self.scale)

        new = self.replace(
            window=carry(self.window, xb).contiguous(),
            raw_tail=carry(self.raw_tail, xa).contiguous(),
        )
        return y, new

    # ------------------------------------------------------------ synthesis
    def synthesizer_execute(self, ych) -> tuple[torch.Tensor, "Firpfbch"]:
        """channels [..., M, N] → x [..., N·M] (dual)."""
        ych = torch.as_tensor(ych, dtype=torch.complex64, device=self.branches.device)
        M = self.num_channels
        n = ych.shape[-1]
        w = _idft(ych) * M  # unnormalized IDFT over k
        xb = torch.cat([self.window, w], dim=-1)
        v = _grouped_branch_conv(xb, self.branches)  # [..., M, n]
        x = v.transpose(-1, -2).reshape(ych.shape[:-2] + (n * M,)) * self.scale
        new = self.replace(
            window=carry(self.window, xb).contiguous(),
        )
        return x, new


@struct.state
class Firpfbch2:
    """Oversampled analysis bank: M channels, M/2 input samples per step
    (liquid firpfbch2, n = 8..64).

    Output step t takes the full-prototype window ending at the newest
    sample: a sliding transform, ``_sliding_residue_conv`` then an M-point
    inverse DFT and the mix-down twiddle of the global sample index. The
    index enters only mod M, so the state carries the step parity.
    """

    num_channels: int = struct.static_field()
    branches: torch.Tensor = struct.field()  # [M, p], branches[b, q] = h[b + qM]
    scale: torch.Tensor = struct.field()  # float32 scalar
    hist: torch.Tensor = struct.field()  # [..., L-1] raw sample history
    step_parity: torch.Tensor = struct.field()  # int64 0-d: output steps so far, mod 2

    @classmethod
    def create(cls, num_channels: int, m: int = 4, as_: float = 60.0,
               batch_shape: tuple = (), device=None) -> "Firpfbch2":
        device = resolve_device(device)
        if num_channels < 2 or num_channels % 2:
            raise ConfigError("number of channels must be even and at least 2")
        M = num_channels
        branches = pfb_decompose(_design_prototype(M, m, as_), M)
        L = branches.shape[1] * M  # full prototype span
        return cls(
            num_channels=M,
            branches=torch.from_numpy(branches.astype(np.float32)).to(device),
            scale=torch.tensor(1.0, dtype=torch.float32, device=device),
            hist=torch.zeros(batch_shape + (L - 1,), dtype=torch.complex64, device=device),
            step_parity=torch.zeros((), dtype=torch.int64, device=device),
        )

    @property
    def p(self) -> int:
        return self.branches.shape[1]

    def reset(self) -> "Firpfbch2":
        return self.replace(
            hist=torch.zeros_like(self.hist),
            step_parity=torch.zeros_like(self.step_parity),
        )

    def analyzer_execute(self, x) -> tuple[torch.Tensor, "Firpfbch2"]:
        """x [..., T·M/2] → channels [..., M, T] (2× oversampled outputs).

        y_k[t] = Σ_j h[j]·x[e_t − j]·e^{−j2πk(e_t − j)/M}
               = e^{−j2πk·e_t/M} Σ_r e^{+j2πkr/M} c_r[t]
        with e_t = (t+1)·M/2 − 1 counted from the stream start.
        """
        x = torch.as_tensor(x, dtype=torch.complex64, device=self.branches.device)
        M = self.num_channels
        half = M // 2
        total = x.shape[-1]
        if total % half:
            raise ConfigError(f"input length must be a multiple of M/2={half}")
        T = total // half
        L = self.p * M
        if T == 0:  # an empty block: no outputs, the state stands
            return x.new_zeros(x.shape[:-1] + (M, 0)), self

        xa = torch.cat([self.hist, x], dim=-1)  # [..., L-1+T·half]
        c = _sliding_residue_conv(xa, self.branches, half)  # [..., T, M]
        Y = torch.fft.ifft(c, dim=-1, norm="forward")  # Σ_r c_r e^{+j2πkr/M}
        t = torch.arange(T, device=x.device)
        e = (t + 1) * half - 1 + self.step_parity * half
        y = (Y * _twiddle(M, e) * self.scale).transpose(-1, -2)  # [..., M, T]

        new = self.replace(
            hist=carry(self.hist, xa).clone(),
            step_parity=(self.step_parity + T) % 2,
        )
        return y, new
