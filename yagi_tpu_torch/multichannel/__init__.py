"""Multichannel channelizers (liquid firpfbch family): the critically
sampled analysis bank and its fused M = 64 kernel path, the 2× oversampled
bank and the arbitrary-rate bank."""

from .firpfbch import Firpfbch, Firpfbch2  # noqa: F401
from .firpfbchr import Firpfbchr  # noqa: F401
from .fused import FusedChannelizer  # noqa: F401
