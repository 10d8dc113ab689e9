"""Error types mirroring the reference's error taxonomy.

Same class names and hierarchy as :mod:`yagi_tpu.errors`: the reference
defines ``Error::{Internal, Config, Value, Range, Mode, NoConvergence}``;
constructors validate parameters eagerly and fail with ``Config``. One class
is the port's own: :class:`DeviceError`.
"""

from __future__ import annotations


class YagiError(Exception):
    """Base class for all yagi_tpu_torch errors."""


class ConfigError(YagiError, ValueError):
    """Invalid configuration parameter (reference: ``Error::Config``)."""


class ValueRangeError(YagiError, ValueError):
    """Value out of range (reference: ``Error::Value`` / ``Error::Range``)."""


class ModeError(YagiError, RuntimeError):
    """Invalid mode of operation (reference: ``Error::Mode``)."""


class NoConvergenceError(YagiError, RuntimeError):
    """Iterative routine failed to converge (reference: ``Error::NoConvergence``)."""


class InternalError(YagiError, RuntimeError):
    """Internal invariant violation (reference: ``Error::Internal``)."""


class DeviceError(YagiError, RuntimeError):
    """No device to build on: an entry point was called without ``device``
    where torch sees no CUDA device. The port's own class (yagi_tpu places
    arrays on JAX's default device)."""
