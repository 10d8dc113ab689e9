"""Spectral waterfall: time-accumulated periodogram rows.

Port of :mod:`yagi_tpu.fft.spwaterfall` (liquid's spwaterfall). Built on
:class:`~.spgram.Spgram`: each completed accumulation period contributes one
PSD row; when the row buffer fills, rows are decimated 2:1 by averaging
(liquid's consolidation), so memory stays fixed while time coverage grows.
The row bookkeeping is host integers, the PSD math on the Spgram's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from ..errors import ConfigError
from ..math.windows import WindowType
from .spgram import Spgram

__all__ = ["Spwaterfall"]


@struct.state
class Spwaterfall:
    """Waterfall accumulator state."""

    time_rows: int = struct.static_field()
    transforms_per_row: int = struct.static_field()
    spgram: Spgram = struct.field()
    psd_rows: torch.Tensor = struct.field()  # [time_rows, nfft] float32
    num_rows: int = struct.field()  # rows filled (a host int)
    row_scale: int = struct.field()  # time decimation factor (a host int)

    @classmethod
    def create(
        cls,
        nfft: int,
        time_rows: int = 64,
        wtype: WindowType = WindowType.KAISER,
        window_len: int | None = None,
        delay: int | None = None,
        transforms_per_row: int = 4,
        dtype=torch.complex64,
        device=None,
    ) -> "Spwaterfall":
        if time_rows < 2:
            raise ConfigError("time size must be at least 2")
        sp = Spgram.create(nfft, wtype, window_len, delay, dtype=dtype, device=device)
        return cls(
            time_rows=time_rows,
            transforms_per_row=transforms_per_row,
            spgram=sp,
            psd_rows=torch.zeros((time_rows, nfft), dtype=torch.float32, device=sp.psd.device),
            num_rows=0,
            row_scale=1,
        )

    @property
    def nfft(self) -> int:
        return self.spgram.nfft

    def reset(self) -> "Spwaterfall":
        return self.replace(
            spgram=self.spgram.reset(),
            psd_rows=torch.zeros_like(self.psd_rows),
            num_rows=0,
            row_scale=1,
        )

    def write(self, x) -> "Spwaterfall":
        """Push samples; emit a PSD row per accumulation period."""
        x = torch.as_tensor(x, device=self.psd_rows.device)
        sp = self.spgram
        rows = self.psd_rows.clone()
        num_rows, row_scale = self.num_rows, self.row_scale
        per_row = self.transforms_per_row * row_scale
        delay = sp.delay
        pos = 0
        n = x.shape[-1]
        # process in chunks that complete accumulation periods
        while pos < n:
            needed_tr = per_row - sp.num_transforms
            needed_samples = needed_tr * delay - (delay - sp.sample_timer)
            take = min(n - pos, max(needed_samples, 1))
            sp = sp.write(x[..., pos : pos + take])
            pos += take
            if sp.num_transforms >= per_row:
                row = sp.get_psd_mag()
                if num_rows == self.time_rows:
                    # decimate rows 2:1 by averaging (liquid consolidation)
                    half = self.time_rows // 2
                    folded = 0.5 * (rows[0 : 2 * half : 2] + rows[1 : 2 * half : 2])
                    rows = torch.zeros_like(rows)
                    rows[:half] = folded
                    num_rows = half
                    row_scale *= 2
                    per_row = self.transforms_per_row * row_scale
                    continue  # keep accumulating into the current period
                rows[num_rows] = row
                num_rows += 1
                sp = sp.clear()
        return self.replace(spgram=sp, psd_rows=rows, num_rows=num_rows, row_scale=row_scale)

    def get_psd(self) -> torch.Tensor:
        """Waterfall in dB, [rows_filled, nfft] (rows oldest-first)."""
        return 10.0 * torch.log10(self.psd_rows[: self.num_rows].clamp_min(1e-12))

    def export_gnuplot(self, base: str) -> None:
        """Write gnuplot script ``base.gnu`` + binary matrix ``base.bin``
        (liquid ``spwaterfall_export``)."""
        psd = self.get_psd().cpu().numpy().astype(np.float32)
        rows, nfft = psd.shape
        with open(base + ".bin", "wb") as fh:
            # gnuplot binary matrix format: first row is nfft then freqs
            header = np.concatenate(
                [[np.float32(nfft)], (np.arange(nfft, dtype=np.float32) / nfft - 0.5)])
            fh.write(header.astype(np.float32).tobytes())
            for r in range(rows):
                fh.write(np.concatenate([[np.float32(r)], psd[r]]).astype(np.float32).tobytes())
        with open(base + ".gnu", "w") as fh:
            fh.write("# %s.gnu: auto-generated by yagi_tpu_torch Spwaterfall\n" % base)
            fh.write("reset\n")
            fh.write("set terminal png size 800,600\n")
            fh.write("set xrange [-0.5:0.5]\n")
            fh.write("set yrange [0:%d]\n" % max(rows - 1, 1))
            fh.write("set xlabel 'Normalized Frequency [f/Fs]'\n")
            fh.write("set ylabel 'Time [rows]'\n")
            fh.write("plot '%s.bin' binary matrix with image notitle\n" % base)
