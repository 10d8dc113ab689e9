"""Random distributions + data scramblers (reference layer L0: src/random/).

The reference's uniform, normal (Box-Muller), exponential, gamma,
Nakagami-m, Rice-K and Weibull samplers with matching pdf/cdf, and the
static-mask data scrambler (scramble.rs:7-37). The reference draws from an
unseeded thread_rng and yagi_tpu from a ``jax.random`` key; here every
sampler takes an explicit ``torch.Generator``, so results are reproducible
from a seed.
"""

from .distributions import (  # noqa: F401
    randf,
    randf_pdf,
    randf_cdf,
    randuf,
    randuf_pdf,
    randuf_cdf,
    randnf,
    crandnf,
    awgn,
    cawgn,
    randnf_pdf,
    randnf_cdf,
    randexpf,
    randexpf_pdf,
    randexpf_cdf,
    randgammaf,
    randgammaf_pdf,
    randgammaf_cdf,
    randnakmf,
    randnakmf_pdf,
    randnakmf_cdf,
    randricekf,
    randricekf_pdf,
    randricekf_cdf,
    randweibf,
    randweibf_pdf,
    randweibf_cdf,
)
from .scramble import scramble_data, unscramble_data, unscramble_data_soft  # noqa: F401
