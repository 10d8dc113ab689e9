"""Automatic gain control (reference layer L5: src/agc/)."""

from .agc import Agc, AgcSquelchMode  # noqa: F401
