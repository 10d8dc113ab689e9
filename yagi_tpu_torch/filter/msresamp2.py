"""Multi-stage halfband resampler (2^k interpolation/decimation).

Port of :mod:`yagi_tpu.filter.msresamp2` (reference: msresamp2.rs): a
cascade of ≤16 :class:`Resamp2` stages with the per-stage fc/As schedule of
msresamp2.rs:67-91, chained through their block forms (each stage halves or
doubles the length), or their valid-prefix forms for a fixed-capacity
buffer with a count on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from .. import design
from .resamp2 import Resamp2

__all__ = ["MsResamp2"]


@struct.state
class MsResamp2:
    """Halfband cascade state (msresamp2.rs:8-24)."""

    interp: bool = struct.static_field()  # True = interpolator
    num_stages: int = struct.static_field()
    stages: tuple[Resamp2, ...] = struct.field()

    @classmethod
    def create(cls, interp: bool, num_stages: int, fc: float = 0.4, f0: float = 0.0,
               as_: float = 60.0, batch_shape: tuple = (), dtype=torch.complex64,
               device=None) -> "MsResamp2":
        """Stage schedule per msresamp2.rs:68-91."""
        device = resolve_device(device)
        if num_stages > 16:
            raise ConfigError("number of stages should not exceed 16")
        if fc <= 0.0 or fc >= 0.5:
            raise ConfigError("cut-off frequency must be in (0,0.5)")
        if f0 != 0.0:
            raise ConfigError("non-zero center frequency not yet supported")

        stages = []
        fc_i, f0_i = fc, f0
        as_i = as_ + 5.0
        for i in range(num_stages):
            fc_i = (0.5 - fc_i) / 2.0 if i == 1 else 0.5 * fc_i
            f0_i = 0.5 * f0_i
            ft = 2.0 * (0.25 - fc_i)
            h_len = design.estimate_req_filter_len(ft, as_i)
            m = max(int(np.ceil((h_len - 1) / 4.0)), 3)
            stages.append(Resamp2.create(m, f0_i, as_i, batch_shape=batch_shape,
                                         dtype=dtype, device=device))
        return cls(interp=interp, num_stages=num_stages, stages=tuple(stages))

    def reset(self) -> "MsResamp2":
        return self.replace(stages=tuple(s.reset() for s in self.stages))

    def get_rate(self) -> float:
        r = float(1 << self.num_stages)
        return r if self.interp else 1.0 / r

    def get_delay(self) -> float:
        """Composite delay (msresamp2.rs:121-137)."""
        delay = 0.0
        if self.interp:
            for i in range(self.num_stages):
                delay = 0.5 * delay + self.stages[self.num_stages - i - 1].m
        else:
            for i in range(self.num_stages):
                delay = 2.0 * delay + (2.0 * self.stages[i].m - 1.0)
        return delay

    def _zeta(self, device) -> torch.Tensor:
        """The decimator's 1/2^k output scaling (msresamp2.rs:57,196)."""
        return torch.tensor(1.0 / (1 << self.num_stages), dtype=torch.float32, device=device)

    def execute_block(self, x):
        """Interp: N → N·2^k (stage 0 first); decim: N·2^k → N (stage k-1
        first), the stage order of msresamp2.rs:155-199. Returns (y, state)."""
        if self.num_stages == 0:
            return x, self
        x = torch.as_tensor(x, device=self.stages[0].h1.device)
        new_stages = list(self.stages)
        y = x
        if self.interp:
            for s in range(self.num_stages):
                y, new_stages[s] = new_stages[s].interp_execute_block(y)
        else:
            for s in range(self.num_stages - 1, -1, -1):
                y, new_stages[s] = new_stages[s].decim_execute_block(y)
            y = y * self._zeta(y.device)
        return y, self.replace(stages=tuple(new_stages))

    __call__ = execute_block

    def execute_block_n(self, x, n_valid):
        """Valid-prefix form: x [..., cap] with the first ``n_valid`` samples
        real (an int or a 0-d integer tensor on x's device) → (y, n_out,
        state), y of capacity cap·2^k (interp; stage 0 first) or cap/2^k
        (decim; stage k-1 first, then the 1/2^k scaling of
        msresamp2.rs:57,196), zeros beyond n_out.

        Decimation requires ``n_valid`` divisible by 2^k (callers group
        inputs, msresamp.rs:144-156)."""
        n = torch.as_tensor(n_valid, dtype=torch.int64, device=x.device)
        if self.num_stages == 0:
            return x, n, self
        new_stages = list(self.stages)
        y = x
        if self.interp:
            for s in range(self.num_stages):
                y, n, new_stages[s] = new_stages[s].interp_execute_block_n(y, n)
        else:
            for s in range(self.num_stages - 1, -1, -1):
                y, n, new_stages[s] = new_stages[s].decim_execute_block_n(y, n)
            y = y * self._zeta(y.device)
        return y, n, self.replace(stages=tuple(new_stages))
