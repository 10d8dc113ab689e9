"""Array utilities, bit utilities and the PSD-mask validators."""

from . import bits  # noqa: F401
from .compact import compact_valid  # noqa: F401
from .psd_validate import (  # noqa: F401
    PsdRegion,
    validate_psd_signal,
    validate_psd_signalf,
    validate_psd_spectrum,
    validate_psd_spgram,
)
