"""Signal generators and the packet layer of framing (reference layer L7:
src/framing/).

Port of :mod:`yagi_tpu.framing`: SymStream/SymStreamR, qpacketmodem,
qdetector, qdsync, qpilotgen/qpilotsync, frame64 gen/sync, with the shared
carrier helpers (``_carrier``); the frame formats built on them (flexframe,
gmskframe, dsssframe64, fskframe), the bit-level packet codec (bpacket),
the binary correlator (bsync), the streaming detector and the multi-signal
source (msource).

Where each part runs: packet-rate byte and bit work (the packetizer's
stages, CRC, the codes, the protocol bytes, ``_carrier``, bpacket) on the
host in numpy, as in yagi_tpu; what yagi_tpu runs in JAX (the Viterbi
decoder, the correlation surfaces, QPilotSync's FFT, the modems,
interpolator and resampler, bsync's correlation) in torch on the object's
device, and so do the synchronizers' sample-rate block maths, in complex128
where yagi_tpu's numpy promotes to it, and msource's sources and mixers.
Every object takes ``device`` (the current CUDA device by default).
"""

from .symstream import SymStream, SymStreamR  # noqa: F401
from .qpacketmodem import QPacketModem  # noqa: F401
from .qdetector import QDetector  # noqa: F401
from .qdsync import QDSync  # noqa: F401
from .qpilot import QPilotGen, QPilotSync  # noqa: F401
from .frame64 import FrameGen64, FrameSync64, frame64_len  # noqa: F401
from .flexframe import FlexFrameGen, FlexFrameSync  # noqa: F401
from .gmskframe import GmskFrameGen, GmskFrameSync  # noqa: F401
from .dsssframe import DsssFrameGen64, DsssFrameSync64  # noqa: F401
from .fskframe import FskFrameGen, FskFrameSync  # noqa: F401
from .msource import MSource  # noqa: F401
from .bsync import BSync  # noqa: F401
from .detector import Detector  # noqa: F401
from .bpacket import BPacketGen, BPacketSync  # noqa: F401


def __getattr__(name):  # FRAME64_LEN stays importable, evaluated lazily
    if name == "FRAME64_LEN":
        return frame64_len()
    raise AttributeError(name)
