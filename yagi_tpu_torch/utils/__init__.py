"""Array utilities, bit and byte utilities, the PSD-mask validators, and
checkpoint / restore of the streaming state objects."""

from . import bits  # noqa: F401
from . import byteops  # noqa: F401
from .checkpoint import (  # noqa: F401
    load_state,
    save_state,
    state_leaves,
)
from .compact import compact_valid  # noqa: F401
from .psd_validate import (  # noqa: F401
    PsdRegion,
    validate_psd_signal,
    validate_psd_signalf,
    validate_psd_spectrum,
    validate_psd_spgram,
)
