"""Oscillators and mixers (reference layer L5), mode "exact"."""

from .osc import Osc, constrain_phase  # noqa: F401
