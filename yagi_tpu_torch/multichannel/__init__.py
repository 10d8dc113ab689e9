"""Multichannel (liquid firpfbch family; yagi stub filled in): the
critically sampled analysis bank and its fused M = 64 kernel path, the 2×
oversampled bank, the arbitrary-rate bank, the OFDM frame generator and
synchronizer, and the OFDM flexible frame with its in-band payload format."""

from .firpfbch import Firpfbch, Firpfbch2  # noqa: F401
from .firpfbchr import Firpfbchr  # noqa: F401
from .ofdm import OfdmFrameGen, OfdmFrameSync, default_sctype  # noqa: F401
from .fused import FusedChannelizer  # noqa: F401
from .ofdmflexframe import OfdmFlexFrameGen, OfdmFlexFrameSync  # noqa: F401
