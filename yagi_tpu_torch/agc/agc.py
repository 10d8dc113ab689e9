"""Automatic gain control.

Port of :mod:`yagi_tpu.agc.agc` (behavioral spec: agc.rs). Per sample
(agc.rs:71-89): y = g·x; y2' = (1−α)·y2' + α·|y|²; g *= exp(−½·α·ln y2')
unless locked, with a 7-state squelch FSM (agc.rs:212-248). The loop is a
feedback recurrence, serial per channel: ``execute_block`` runs it as the
kernel ``agc_scan`` (:mod:`yagi_tpu_torch.kernels.agc`), batched over
channels.
"""

from __future__ import annotations

import enum
import math

import torch

from .. import trace
from .._src import struct
from .._src.device import resolve_device
from ..errors import ConfigError
from ..kernels.agc import agc_scan_apply, agc_scan_reference

__all__ = ["Agc", "AgcSquelchMode"]

_AGC_DEFAULT_BW = 1e-2


class AgcSquelchMode(enum.IntEnum):
    """Squelch FSM states (agc.rs:22-31)."""

    DISABLED = 0
    ENABLED = 1
    RISE = 2
    SIGNAL_HI = 3
    FALL = 4
    SIGNAL_LO = 5
    TIMEOUT = 6


@struct.state
class Agc:
    """AGC state (agc.rs:8-20)."""

    squelch_timeout: int = struct.static_field()
    g: torch.Tensor = struct.field()  # gain
    scale: torch.Tensor = struct.field()
    alpha: torch.Tensor = struct.field()  # loop bandwidth
    y2_prime: torch.Tensor = struct.field()  # filtered output energy
    locked: torch.Tensor = struct.field()  # bool
    squelch_mode: torch.Tensor = struct.field()  # int32 FSM state
    squelch_threshold: torch.Tensor = struct.field()
    squelch_timer: torch.Tensor = struct.field()  # int32

    @classmethod
    def create(cls, bandwidth: float = _AGC_DEFAULT_BW, batch_shape: tuple = (),
               device=None) -> "Agc":
        device = resolve_device(device)
        if not 0.0 <= bandwidth <= 1.0:
            raise ConfigError("bandwidth must be in [0, 1]")

        def full(v, dt=torch.float32):
            return torch.full(batch_shape, v, dtype=dt, device=device)

        return cls(
            squelch_timeout=100,
            g=full(1.0),
            scale=full(1.0),
            alpha=full(bandwidth),
            y2_prime=full(1.0),
            locked=full(False, torch.bool),
            squelch_mode=full(AgcSquelchMode.DISABLED, torch.int32),
            squelch_threshold=full(0.0),
            squelch_timer=full(100, torch.int32),
        )

    def _like(self, v, field: torch.Tensor) -> torch.Tensor:
        """``v`` as float32 broadcast to ``field``'s shape, on its device."""
        t = torch.as_tensor(v, dtype=torch.float32, device=field.device)
        return torch.broadcast_to(t, field.shape).clone()

    # ---------------------------------------------------------------- control
    def reset(self) -> "Agc":
        """Reset gain and energy; squelch back to ENABLED unless disabled
        (agc.rs:60)."""
        return self.replace(
            g=torch.ones_like(self.g),
            y2_prime=torch.ones_like(self.y2_prime),
            locked=torch.zeros_like(self.locked),
            squelch_mode=torch.where(self.squelch_mode == AgcSquelchMode.DISABLED,
                                     AgcSquelchMode.DISABLED,
                                     AgcSquelchMode.ENABLED).to(torch.int32),
        )

    def lock(self) -> "Agc":
        return self.replace(locked=torch.ones_like(self.locked))

    def unlock(self) -> "Agc":
        return self.replace(locked=torch.zeros_like(self.locked))

    def set_bandwidth(self, bt) -> "Agc":
        if isinstance(bt, (int, float)) and not 0.0 <= bt <= 1.0:
            raise ConfigError("bandwidth must be in [0, 1]")
        return self.replace(alpha=self._like(bt, self.alpha))

    def get_bandwidth(self):
        return self.alpha

    def get_signal_level(self):
        return 1.0 / self.g

    def set_signal_level(self, x2) -> "Agc":
        if isinstance(x2, (int, float)) and x2 <= 0.0:
            raise ConfigError("signal level must be greater than zero")
        x2 = torch.as_tensor(x2, dtype=torch.float32, device=self.g.device)
        return self.replace(g=self._like(1.0 / x2, self.g), y2_prime=torch.ones_like(self.y2_prime))

    def get_rssi(self):
        """RSSI estimate −20·log10(g) (agc.rs:136)."""
        return -20.0 * torch.log10(self.g)

    def set_rssi(self, rssi) -> "Agc":
        rssi = torch.as_tensor(rssi, dtype=torch.float32, device=self.g.device)
        g = torch.clamp(10.0 ** (-rssi / 20.0), min=1e-16)
        return self.replace(g=self._like(g, self.g), y2_prime=torch.ones_like(self.y2_prime))

    def get_gain(self):
        return self.g

    def set_gain(self, gain) -> "Agc":
        if isinstance(gain, (int, float)) and gain <= 0.0:
            raise ConfigError("gain must be greater than zero")
        return self.replace(g=self._like(gain, self.g))

    def set_scale(self, scale) -> "Agc":
        if isinstance(scale, (int, float)) and scale <= 0.0:
            raise ConfigError("scale must be greater than zero")
        return self.replace(scale=self._like(scale, self.scale))

    def get_scale(self):
        return self.scale

    def init(self, x) -> "Agc":
        """Estimate the signal level from a block (agc.rs:171-178)."""
        x = torch.as_tensor(x, device=self.g.device)
        if x.shape[-1] == 0:
            raise ConfigError("number of samples must be greater than zero")
        return self.set_signal_level(torch.sqrt(x.abs().square().mean(-1)) + 1e-16)

    # ---------------------------------------------------------------- squelch
    def squelch_enable(self) -> "Agc":
        return self.replace(squelch_mode=torch.full_like(self.squelch_mode, AgcSquelchMode.ENABLED))

    def squelch_disable(self) -> "Agc":
        return self.replace(squelch_mode=torch.full_like(self.squelch_mode,
                                                         AgcSquelchMode.DISABLED))

    def squelch_set_threshold(self, threshold) -> "Agc":
        return self.replace(squelch_threshold=self._like(threshold, self.squelch_threshold))

    def squelch_get_threshold(self):
        return self.squelch_threshold

    def squelch_set_timeout(self, timeout: int) -> "Agc":
        """Hysteresis timeout in samples (agc.rs:200-202); a countdown in
        progress keeps its timer, as in the reference."""
        if timeout <= 0:
            raise ConfigError("squelch timeout must be greater than zero")
        return self.replace(squelch_timeout=int(timeout))

    def squelch_get_timeout(self) -> int:
        return self.squelch_timeout

    def squelch_is_enabled(self):
        return self.squelch_mode != AgcSquelchMode.DISABLED

    def squelch_get_status(self):
        return self.squelch_mode

    # ------------------------------------------------------------- streaming
    def execute_block(self, x, samples_per_step: int | None = None
                      ) -> tuple[torch.Tensor, "Agc"]:
        """Gain-control a block x [..., n] (agc.rs:91), complex or real.

        The state broadcasts to x's leading shape, flattened to C channels
        for the kernel. ``samples_per_step`` is checked to divide n and has
        no other effect: the output is the same for any value (on the TPU it
        packed samples into scan steps).
        """
        x = torch.as_tensor(x, device=self.g.device)
        n = x.shape[-1]
        S = 1 if samples_per_step is None else samples_per_step
        if S < 1 or n % S != 0:
            raise ConfigError("samples_per_step must divide the block length")
        return self._run(x, plain=False)

    @trace.spanned("yagi.agc.run")
    def _run(self, x, plain: bool):
        """The block through ``agc_scan``: the kernel wrapper, or with
        ``plain`` its plain version on any device (the chain's oracle)."""
        n = x.shape[-1]
        if n == 0:  # an empty block: no outputs, the state stands
            return x.to(torch.complex64 if x.is_complex() else x.dtype), self
        batch = x.shape[:-1]
        C = math.prod(batch)

        def flat(v):
            return torch.broadcast_to(v, batch).reshape(C).contiguous()

        xc = x.reshape(C, n)
        xc = xc.to(torch.complex64) if x.is_complex() else torch.complex(
            xc.to(torch.float32), torch.zeros_like(xc, dtype=torch.float32))
        scan = agc_scan_reference if plain else agc_scan_apply
        y, g, y2p, mode, timer = scan(
            xc.contiguous(), flat(self.g), flat(self.y2_prime), flat(self.alpha),
            flat(self.scale), flat(self.squelch_threshold), flat(self.locked),
            flat(self.squelch_mode), flat(self.squelch_timer), timeout=self.squelch_timeout)
        y = y.reshape(x.shape) if x.is_complex() else y.real.reshape(x.shape).to(x.dtype)
        return y, self.replace(g=g.reshape(batch), y2_prime=y2p.reshape(batch),
                               squelch_mode=mode.reshape(batch), squelch_timer=timer.reshape(batch))

    __call__ = execute_block

    def execute(self, x):
        """Single-sample form (agc.rs:71): x [...] → (y [...], state)."""
        x = torch.as_tensor(x, device=self.g.device)
        y, q = self.execute_block(x[..., None])
        return y[..., 0], q
