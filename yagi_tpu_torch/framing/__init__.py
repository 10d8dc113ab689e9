"""Signal generators and the packet layer of framing (reference layer L7:
src/framing/).

Port of :mod:`yagi_tpu.framing`'s packet layer: SymStream/SymStreamR,
qpacketmodem, qdetector, qdsync, qpilotgen/qpilotsync and frame64 gen/sync,
with the shared carrier helpers (``_carrier``). The frame formats built on
it (flexframe, gmskframe, dsssframe, fskframe, bpacket) and msource, bsync
and detector are not ported yet.

Where each part runs: packet-rate byte and bit work (the packetizer's
stages, CRC, the codes, ``_carrier``) on the host in numpy, as in yagi_tpu;
what yagi_tpu runs in JAX (the Viterbi decoder, QDetector's correlation
surface, QPilotSync's FFT, SymStream's modem, interpolator and resampler)
in torch on the object's device, and so do the synchronizers' sample-rate
block maths, in complex128 where yagi_tpu's numpy promotes to it. Every
object takes ``device`` (the current CUDA device by default).
"""

from .symstream import SymStream, SymStreamR  # noqa: F401
from .qpacketmodem import QPacketModem  # noqa: F401
from .qdetector import QDetector  # noqa: F401
from .qdsync import QDSync  # noqa: F401
from .qpilot import QPilotGen, QPilotSync  # noqa: F401
from .frame64 import FrameGen64, FrameSync64, frame64_len  # noqa: F401


def __getattr__(name):  # FRAME64_LEN stays importable, evaluated lazily
    if name == "FRAME64_LEN":
        return frame64_len()
    raise AttributeError(name)
