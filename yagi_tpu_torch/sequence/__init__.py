"""Binary sequences (reference layer L0: src/sequence/), host-side."""

from .msequence import MSequence  # noqa: F401
from .bsequence import BSequence  # noqa: F401
