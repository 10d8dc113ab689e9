"""Composed receive chains, each a state object with a ``step``."""

from .rx import RxChain  # noqa: F401
from .fused import FusedRxChain  # noqa: F401
from .qam import QamRx  # noqa: F401
from .fm import FmStereoRx  # noqa: F401
from .chzfm import ChannelizerFmRx  # noqa: F401
