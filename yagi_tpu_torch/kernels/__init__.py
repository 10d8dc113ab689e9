"""Hand-written Hopper kernels for the hot paths, each beside its plain
torch version (which CPU tensors run)."""

from .chain import chain_matrices, fused_chain_apply, fused_chain_reference  # noqa: F401
