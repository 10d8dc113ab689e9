"""Multichannel channelizers (liquid firpfbch family): the analysis bank and
its fused M = 64 kernel path."""

from .firpfbch import Firpfbch  # noqa: F401
from .fused import FusedChannelizer  # noqa: F401
