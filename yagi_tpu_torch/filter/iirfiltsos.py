"""Single second-order section (biquad).

Port of :mod:`yagi_tpu.filter.iirfiltsos` (reference: iirfiltsos.rs),
direct form II (execute_df2, iirfiltsos.rs:103). A block runs through
``kernels/iir.py`` as a one-section SOS filter with unit scale: the
sequential recurrence (``iir_scan``) or, once ``parallelize()``d, the
chunked one (``iir_chunked``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..design import iir as iirdes
from ..errors import ConfigError
from .iirfilt import run_recurrence

__all__ = ["IirFilterSos"]


@struct.state
class IirFilterSos:
    """Biquad state (iirfiltsos.rs:7-15); df2 carries (v1, v2)."""

    b: torch.Tensor = struct.field()  # [3] normalized feed-forward
    a: torch.Tensor = struct.field()  # [3] normalized feed-back (a[0] = 1)
    v: torch.Tensor = struct.field()  # [..., 2] direct-form-II state (v1, v2)
    # the chunked block path (iir_chunked); fp32-tolerance-equal to the
    # sequential recurrence
    parallel: bool = struct.static_field(default=False)

    @classmethod
    def create(cls, b, a, batch_shape: tuple = (), dtype=torch.float32,
               device=None) -> "IirFilterSos":
        device = resolve_device(device)
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        if b.shape != (3,) or a.shape != (3,):
            raise ConfigError("biquad needs exactly 3 feed-forward and 3 feed-back coefficients")
        if a[0] == 0:
            raise ConfigError("a[0] cannot be zero")
        return cls(
            b=torch.from_numpy((b / a[0]).astype(np.float32)).to(device),
            a=torch.from_numpy((a / a[0]).astype(np.float32)).to(device),
            v=torch.zeros(tuple(batch_shape) + (2,), dtype=dtype, device=device),
        )

    def reset(self) -> "IirFilterSos":
        return self.replace(v=torch.zeros_like(self.v))

    def execute(self, x):
        """One sample, direct form II (iirfiltsos.rs:103)."""
        x = torch.as_tensor(x, device=self.v.device)
        v1 = self.v[..., 0]
        v2 = self.v[..., 1]
        v0 = x - self.a[1] * v1 - self.a[2] * v2
        y = self.b[0] * v0 + self.b[1] * v1 + self.b[2] * v2
        return y, self.replace(v=torch.stack([v0, v1], dim=-1))

    def parallelize(self) -> "IirFilterSos":
        """Switch block processing to the chunked recurrence."""
        return self.replace(parallel=True)

    def execute_block(self, x):
        """Block over the time axis (last axis)."""
        x = torch.as_tensor(x, device=self.v.device)
        return self._run(x, plain=False)

    def _run(self, x, plain: bool):
        """The block through the kernel wrappers, or with ``plain`` their
        plain versions on any device."""
        one = torch.ones((), dtype=self.b.dtype, device=self.b.device)
        y, v = run_recurrence(x, self.b[None], self.a[None], one, self.v[..., None, :], sos=True,
                              parallel=self.parallel, plain=plain)
        return y, self.replace(v=v[..., 0, :])

    __call__ = execute_block

    def groupdelay(self, fc: float) -> float:
        """Group delay (iirfiltsos.rs:120ff)."""
        b = self.b.cpu().numpy()
        a = self.a.cpu().numpy()
        return iirdes.iir_group_delay(b, a, fc) + 2.0
