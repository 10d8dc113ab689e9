"""Audio codecs (liquid upstream's audio module): CVSD."""

from .cvsd import Cvsd  # noqa: F401

__all__ = ["Cvsd"]
