"""Streaming spectral periodogram, a block at a time.

Port of :mod:`yagi_tpu.fft.spgram` (behavioral spec: the reference's
fft/spgram.rs). The reference pushes one sample at a time into a sliding
window and runs one FFT every ``delay`` samples (spgram.rs:237-288). Here a
whole block is processed at once: every frame that fires inside the block
is a strided view of ``[buffer | block]``, the frames go through ONE batched
FFT, and the PSD recurrence is applied in closed form:

  accumulate mode (alpha = -1): psd += Σ |F_t|²
  exponential mode:             psd' = γ^k psd + α Σ γ^{k-1-t} |F_t|²

which is the per-transform recurrence psd = γ·psd + α·|F|² (spgram.rs:276-283)
unrolled. Which frames fire depends only on the sample counts, so the
counters are host integers and a block needs no device round trip.

As in yagi_tpu, ``get_psd_mag`` scales by 1.0 in exponential mode where the
reference scales by 0 (spgram.rs:295-299, a porting slip; liquid uses 1.0).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..math import windows as mwin
from ..math.windows import WindowType
from ._input import as_signal

__all__ = ["Spgram", "spgram_estimate_psd", "SPGRAM_PSD_MIN"]

SPGRAM_PSD_MIN = 1e-12  # spgram.rs:11


def _design_window(wtype: WindowType, window_len: int) -> np.ndarray:
    """Window + energy normalization g = 1/sqrt(Σ w²) (spgram.rs:92-118)."""
    beta = 10.0
    zeta = 3.0
    if wtype == WindowType.KAISER:
        w = mwin.kaiser(window_len, beta)
    elif wtype == WindowType.TRIANGULAR:
        w = mwin.triangular(window_len, window_len)
    elif wtype == WindowType.RCOS_TAPER:
        w = mwin.rcos_taper(window_len, window_len // 3)
    elif wtype == WindowType.KBD:
        w = mwin.kbd_window(window_len, zeta)
    else:
        w = mwin.window(wtype, window_len)
    g = 1.0 / np.sqrt(np.sum(w * w))
    return (g * w).astype(np.float32)


def _mag_sq(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    """|FFT|² of each windowed frame [k, wl], zero-padded to nfft."""
    f = torch.fft.fft(frames, n=nfft, dim=-1)
    return (f * f.conj()).real.to(torch.float32)


@struct.state
class Spgram:
    """Streaming spectral periodogram state (spgram.rs:14-41).

    ``buffer`` carries the last ``window_len`` input samples (oldest ..
    newest) and ``psd`` the accumulated |F|²; the counters are stream state
    held as host ints (non-static fields, so a checkpoint carries them).
    """

    nfft: int = struct.static_field()
    window_len: int = struct.static_field()
    delay: int = struct.static_field()
    wtype: WindowType = struct.static_field()
    alpha: float = struct.static_field()
    gamma: float = struct.static_field()
    accumulate: bool = struct.static_field()

    w: torch.Tensor = struct.field()  # [window_len] normalized window, float32
    buffer: torch.Tensor = struct.field()  # [window_len] sample history
    psd: torch.Tensor = struct.field()  # [nfft] accumulated |F|², float32

    sample_timer: int = struct.field()
    num_samples: int = struct.field()
    num_samples_total: int = struct.field()
    num_transforms: int = struct.field()
    num_transforms_total: int = struct.field()

    # ------------------------------------------------------------------ ctor
    @classmethod
    def create(
        cls,
        nfft: int,
        wtype: WindowType = WindowType.KAISER,
        window_len: int | None = None,
        delay: int | None = None,
        alpha: float = -1.0,
        dtype=torch.complex64,
        device=None,
    ) -> "Spgram":
        """Create spgram (spgram.rs:49-123); defaults per spgram.rs:126-132."""
        device = resolve_device(device)
        if window_len is None:
            window_len = nfft // 2
        if delay is None:
            delay = nfft // 4
        if nfft < 2:
            raise ConfigError("fft size must be at least 2")
        if window_len > nfft:
            raise ConfigError("window size cannot exceed fft size")
        if window_len == 0:
            raise ConfigError("window size must be greater than zero")
        if wtype in (WindowType.KAISER, WindowType.KBD) and window_len % 2 != 0:
            # the reference enforces an even length for its Kaiser/KBD path
            raise ConfigError("window length must be even for Kaiser/KBD window")
        if delay == 0:
            raise ConfigError("delay must be greater than 0")
        if alpha != -1.0 and not (0.0 <= alpha <= 1.0):
            raise ConfigError("alpha must be -1 or in [0,1]")

        accumulate = alpha == -1.0
        return cls(
            nfft=nfft,
            window_len=window_len,
            delay=delay,
            wtype=wtype,
            alpha=1.0 if accumulate else float(alpha),
            gamma=1.0 if accumulate else 1.0 - alpha,
            accumulate=accumulate,
            w=torch.from_numpy(_design_window(wtype, window_len)).to(device),
            buffer=torch.zeros(window_len, dtype=dtype, device=device),
            psd=torch.zeros(nfft, dtype=torch.float32, device=device),
            sample_timer=delay,
            num_samples=0,
            num_samples_total=0,
            num_transforms=0,
            num_transforms_total=0,
        )

    # ------------------------------------------------------------- streaming
    def write(self, x) -> "Spgram":
        """Process a block of samples; returns the updated state (spgram.rs:254).

        Transform t fires after local sample i_t = (sample_timer − 1) + t·delay
        for every i_t < n; frame t is xa[i_t + 1 : i_t + 1 + window_len] of
        xa = [buffer | x].
        """
        x = torch.as_tensor(x, device=self.psd.device).to(self.buffer.dtype)
        n = x.shape[0]
        wl = self.window_len
        xa = torch.cat([self.buffer, x])
        first = self.sample_timer - 1
        k = 0 if first >= n else (n - 1 - first) // self.delay + 1

        psd = self.psd
        if k:
            frames = xa[first + 1 :].unfold(0, wl, self.delay)  # [k, wl], a view
            mag_sq = _mag_sq(frames * self.w.to(frames.dtype), self.nfft)
            if self.accumulate:
                psd = psd + mag_sq.sum(dim=0)
            else:
                gamma = torch.tensor(self.gamma, dtype=torch.float32, device=psd.device)
                powers = gamma ** torch.arange(k - 1, -1, -1, device=psd.device)
                weight = self.alpha * powers  # γ^{k-1-t}·α
                if self.num_transforms == 0:
                    # the very first transform sets the PSD (spgram.rs:278-282):
                    # its term is decayed k−1 times, unweighted by α
                    weight[0] = powers[0]
                    psd = (weight[:, None] * mag_sq).sum(dim=0)
                else:
                    psd = gamma**k * psd + (weight[:, None] * mag_sq).sum(dim=0)
            since_fire = n - 1 - (first + (k - 1) * self.delay)
            timer = self.delay - since_fire
        else:
            timer = self.sample_timer - n

        return self.replace(
            buffer=xa[xa.shape[0] - wl :].clone(),
            psd=psd,
            sample_timer=timer,
            num_samples=self.num_samples + n,
            num_samples_total=self.num_samples_total + n,
            num_transforms=self.num_transforms + k,
            num_transforms_total=self.num_transforms_total + k,
        )

    push = write  # single samples are length-1 blocks

    def step(self) -> "Spgram":
        """Force one transform from the current buffer (spgram.rs:261)."""
        mag_sq = _mag_sq(self.buffer * self.w.to(self.buffer.dtype), self.nfft)
        if self.accumulate:
            psd = self.psd + mag_sq
        elif self.num_transforms == 0:
            psd = mag_sq
        else:
            psd = self.gamma * self.psd + self.alpha * mag_sq
        return self.replace(
            psd=psd,
            num_transforms=self.num_transforms + 1,
            num_transforms_total=self.num_transforms_total + 1,
        )

    # ------------------------------------------------------------- accessors
    def get_nfft(self) -> int:
        return self.nfft

    def get_window_len(self) -> int:
        return self.window_len

    def get_delay(self) -> int:
        return self.delay

    def get_alpha(self) -> float:
        """Smoothing factor; -1 in accumulate mode (spgram.rs get_alpha)."""
        return -1.0 if self.accumulate else self.alpha

    def set_alpha(self, alpha: float) -> "Spgram":
        """Switch accumulate (-1) / exponential smoothing (spgram.rs:158-183)."""
        if alpha != -1.0 and not (0.0 <= alpha <= 1.0):
            raise ConfigError("alpha must be -1 or in [0,1]")
        accumulate = alpha == -1.0
        return self.replace(
            accumulate=accumulate,
            alpha=1.0 if accumulate else float(alpha),
            gamma=1.0 if accumulate else 1.0 - float(alpha),
        )

    def set_rate(self, rate: float) -> "Spgram":
        """Display sample rate; must be positive (spgram.rs set_rate)."""
        if rate <= 0.0:
            raise ConfigError("sample rate must be greater than zero")
        return self  # display-only in the reference; no state to carry

    # --------------------------------------------------------------- output
    def get_psd_mag(self) -> torch.Tensor:
        """FFT-shifted linear PSD (spgram.rs:292-305)."""
        shifted = torch.roll(self.psd, self.nfft // 2)
        mag = shifted.clamp_min(SPGRAM_PSD_MIN)
        if self.accumulate:
            return mag * float(np.float32(1.0) / np.float32(max(1, self.num_transforms)))
        return mag

    def get_psd(self) -> torch.Tensor:
        """FFT-shifted PSD in dB (spgram.rs:309-316)."""
        return 10.0 * torch.log10(self.get_psd_mag())

    def export_gnuplot(self, path: str) -> None:
        """Write a standalone gnuplot script of the current PSD
        (liquid ``spgram_export_gnuplot``)."""
        psd = self.get_psd().cpu().numpy()
        f = np.arange(self.nfft) / self.nfft - 0.5
        with open(path, "w") as fh:
            fh.write("# %s: auto-generated by yagi_tpu_torch Spgram\n" % path)
            fh.write("reset\n")
            fh.write("set terminal png size 800,600\n")
            fh.write("set xrange [-0.5:0.5]\n")
            fh.write("set xlabel 'Normalized Frequency [f/Fs]'\n")
            fh.write("set ylabel 'PSD [dB]'\n")
            fh.write("set grid\n")
            fh.write("plot '-' w lines lw 2 notitle\n")
            for fi, pi in zip(f, psd):
                fh.write("%12.8f %12.6f\n" % (fi, pi))
            fh.write("e\n")

    def clear(self) -> "Spgram":
        """Reset the accumulation but keep the sample buffer (spgram.rs:136)."""
        return self.replace(
            psd=torch.zeros_like(self.psd),
            sample_timer=self.delay,
            num_samples=0,
            num_transforms=0,
        )

    def reset(self) -> "Spgram":
        """Full reset (spgram.rs:151)."""
        return self.clear().replace(
            buffer=torch.zeros_like(self.buffer),
            num_samples_total=0,
            num_transforms_total=0,
        )


def spgram_estimate_psd(nfft: int, x, wtype: WindowType = WindowType.KAISER,
                        device=None) -> torch.Tensor:
    """One-shot PSD estimate (spgram.rs:319-329), on ``x``'s device."""
    x = as_signal(x, device)
    sp = Spgram.create(nfft, wtype=wtype, dtype=x.dtype, device=x.device).write(x)
    if sp.num_transforms == 0:
        sp = sp.step()
    return sp.get_psd()
