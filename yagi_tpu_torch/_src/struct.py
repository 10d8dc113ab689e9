"""Frozen dataclass machinery for stateful DSP objects.

Every streaming object is an immutable frozen dataclass, threaded through
calls as ``y, obj = obj.execute_block(x)``, as in :mod:`yagi_tpu._src.struct`.
Tensor fields hold coefficients and carried stream state; static fields hold
structural configuration (lengths, modes, schedule certificates).

Unsigned 32-bit state (resampler and oscillator phases) is held as int64 in
[0, 2^32): torch has no general uint32 arithmetic. Every update masks with
``U32``, so the values equal the reference's wrapping u32 accumulators.
"""

from __future__ import annotations

import dataclasses
import enum
import types
import typing
from typing import Any, TypeVar

import numpy as np
import torch

from .device import resolve_device

_T = TypeVar("_T")

U32 = 0xFFFFFFFF


def static_field(**kwargs) -> Any:
    """A dataclass field holding static configuration (not a tensor)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs) -> Any:
    """A tensor-valued dataclass field."""
    return dataclasses.field(**kwargs)


def state(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass with a ``replace(**updates)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = _replace  # type: ignore[attr-defined]
    return cls


def _as_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_state(tp) -> bool:
    return isinstance(tp, type) and dataclasses.is_dataclass(tp) and hasattr(tp, "replace")


def _load_value(tp, v, device):
    """One field value: a nested state object, a tuple of them, a tensor, a
    host number (a counter held as an ``int`` field), or None for an
    optional field (``X | None``) that holds none."""
    if typing.get_origin(tp) in (typing.Union, types.UnionType):
        if v is None:
            return None
        tp = next(a for a in typing.get_args(tp) if a is not type(None))
    if tp in (int, float, bool):
        return tp(np.asarray(v))
    if _is_state(tp):
        return load_state(tp, v, device)
    if typing.get_origin(tp) is tuple:
        elem = typing.get_args(tp)[0]
        return tuple(_load_value(elem, e, device) for e in v)
    return _as_tensor(v, device)


def load_state(cls: type[_T], arrays, device=None) -> _T:
    """Build a ``cls`` object from another implementation's field values.

    ``arrays`` is the matching yagi_tpu object, or a dict mapping field names
    to numpy arrays (or anything ``np.asarray`` takes). uint32 becomes int64
    in [0, 2^32); other dtypes (float32, complex64, int32, bool) are kept.
    Static fields pass through unchanged. A field annotated with a state
    class (or ``tuple[StateClass, ...]``, or ``StateClass | None``) loads
    recursively from the nested object(s), so a composite (``MsResamp`` with its ``Resamp``,
    ``MsResamp2`` and ``Resamp2`` stages) loads whole. Values that ``cls``
    has no field for (a Pallas ``interpret`` flag, a TPU-only matrix such as
    Symsync's ``bank_g``) are ignored; a missing field falls back to its
    default or raises ``KeyError``.
    """
    device = resolve_device(device)
    if not isinstance(arrays, dict):
        arrays = {f.name: getattr(arrays, f.name) for f in dataclasses.fields(arrays)}
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__}: no value for field {f.name!r}")
            continue
        v = arrays[f.name]
        kw[f.name] = v if f.metadata.get("static", False) else _load_value(hints[f.name], v, device)
    return cls(**kw)


def load_into(obj, source, device=None):
    """Carry another implementation's stream state into ``obj``, a plain
    (mutable) object of the same class built with the same configuration
    (a symbol stream, whose fields are not a frozen state class).

    Each attribute of ``obj`` loads from ``source``'s attribute of the same
    name: a state object by :func:`load_state`, a tensor from the array
    (keeping ``obj``'s dtype), a Python number (a gain, an LFSR register)
    by value, a numpy ``Generator`` by its bit generator's state, a plain
    object of its own attributes recursively, and a dict of plain objects
    (a source list) key by key. Enums and devices are ``obj``'s own.
    Returns ``obj``.
    """
    device = resolve_device(device)
    for name, v in list(vars(obj).items()):
        src = getattr(source, name, None)
        if src is None or isinstance(v, (enum.Enum, torch.device)):
            continue
        if _is_state(type(v)):
            setattr(obj, name, load_state(type(v), src, device))
        elif isinstance(v, torch.Tensor):
            setattr(obj, name, _as_tensor(src, device).to(v.dtype))
        elif isinstance(v, (bool, int, float)):
            setattr(obj, name, type(v)(src))
        elif isinstance(v, np.random.Generator):
            v.bit_generator.state = src.bit_generator.state
        elif isinstance(v, dict):
            for key, item in v.items():
                if key in src and hasattr(item, "__dict__"):
                    load_into(item, src[key], device)
        elif hasattr(v, "__dict__"):
            load_into(v, src, device)
    return obj
