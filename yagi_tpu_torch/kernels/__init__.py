"""Hand-written Hopper kernels for the hot paths, each beside its plain
torch version (which CPU tensors run)."""

from .agc import agc_scan_apply, agc_scan_reference  # noqa: F401
from .chain import chain_matrices, fused_chain_apply, fused_chain_reference  # noqa: F401
from .channelizer import (  # noqa: F401
    channelizer_tables,
    fused_channelizer_apply,
    fused_channelizer_reference,
)
from .iir import (  # noqa: F401
    iir_chunked_apply,
    iir_chunked_reference,
    iir_scan_apply,
    iir_scan_reference,
)
from .mix import mix_down_apply, mix_down_reference  # noqa: F401
from .symscan import (  # noqa: F401
    branch_outputs,
    symsync_fused_apply,
    symsync_fused_reference,
    symsync_scan_apply,
    symsync_scan_reference,
    symsync_scan_xla,
)
from .qam import qam_eq_scan_apply, qam_eq_scan_reference  # noqa: F401
