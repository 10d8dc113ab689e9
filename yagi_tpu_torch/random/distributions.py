"""Seeded random distributions with liquid's pdf/cdf forms.

Port of :mod:`yagi_tpu.random.distributions` (the reference's
random/{uniform,normal,exp,gamma,nakm,ricek,weib}.rs). The samplers draw
tensors from an explicit ``torch.Generator`` where yagi_tpu takes a
``jax.random`` key: reproducible from a seed, statistically equivalent, not
the same draws. They use no global generator and no ``torch.distributions``
sampler (neither takes a generator); the gamma family is Marsaglia and
Tsang's rejection method on the generator's normals and uniforms. Tensors
are made on ``device`` (``resolve_device``: the card unless the caller asks
for the CPU), which must be the generator's. The pdf/cdf helpers are host
float64 NumPy, copied from yagi_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._src.device import resolve_device
from ..errors import ConfigError
from ..math.special import besseli0f, gammaf, lowergammaf, marcumq1f, qf

__all__ = [
    "randf", "randf_pdf", "randf_cdf",
    "randuf", "randuf_pdf", "randuf_cdf",
    "randnf", "crandnf", "awgn", "cawgn", "randnf_pdf", "randnf_cdf",
    "randexpf", "randexpf_pdf", "randexpf_cdf",
    "randgammaf", "randgammaf_pdf", "randgammaf_cdf",
    "randnakmf", "randnakmf_pdf", "randnakmf_cdf",
    "randricekf", "randricekf_pdf", "randricekf_cdf",
    "randweibf", "randweibf_pdf", "randweibf_cdf",
]


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform(generator, shape, device) -> torch.Tensor:
    """U[0, 1) float32."""
    return torch.rand(_shape(shape), generator=generator, device=resolve_device(device),
                      dtype=torch.float32)


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(_shape(shape), generator=generator, device=resolve_device(device),
                       dtype=torch.float32)


def _positive_uniform(generator, shape, device) -> torch.Tensor:
    """U[1e-12, 1): the inverse transforms take its log."""
    return _uniform(generator, shape, device) + 1e-12


def _standard_gamma(generator, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(α, 1) float32 by Marsaglia and Tsang's method: d = α − 1/3,
    c = 1/√(9d), v = (1 + c·x)³ for x ~ N(0, 1), kept where log u <
    x²/2 + d − d·v + d·log v; the rejected entries draw again. For α < 1,
    Gamma(α + 1)·u^(1/α)."""
    device = resolve_device(device)
    shape = _shape(shape)
    boost = alpha < 1.0
    d = (alpha + 1.0 if boost else alpha) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float32, device=device).reshape(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator, device=device, dtype=torch.float32)
        u = torch.rand(todo.numel(), generator=generator, device=device, dtype=torch.float32)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        out = out * _positive_uniform(generator, out.shape, device) ** (1.0 / alpha)
    return out.reshape(shape)


def _like(x, device) -> torch.Tensor:
    """x as a tensor: a tensor stays on its device."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=resolve_device(device))


# ------------------------------------------------------------------ uniform
def randf(generator, shape=(), device=None):
    """U[0,1) (uniform.rs:5)."""
    return _uniform(generator, shape, device)


def randf_pdf(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where((x >= 0) & (x < 1), 1.0, 0.0)


def randf_cdf(x):
    return np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)


def randuf(generator, a: float, b: float, shape=(), device=None):
    """U[a,b) (uniform.rs:31)."""
    if a >= b:
        raise ConfigError("a must be less than b")
    return (_uniform(generator, shape, device) * (b - a) + a).clamp(min=a)


def randuf_pdf(x, a: float, b: float):
    if a >= b:
        raise ConfigError("a must be less than b")
    x = np.asarray(x, dtype=np.float64)
    return np.where((x >= a) & (x < b), 1.0 / (b - a), 0.0)


def randuf_cdf(x, a: float, b: float):
    if a >= b:
        raise ConfigError("a must be less than b")
    x = np.asarray(x, dtype=np.float64)
    return np.clip((x - a) / (b - a), 0.0, 1.0)


# ------------------------------------------------------------------- normal
def randnf(generator, shape=(), device=None):
    """Standard normal (normal.rs:9, Box-Muller there; torch's generator here)."""
    return _normal(generator, shape, device)


def crandnf(generator, shape=(), device=None):
    """Circular complex normal: re,im ~ N(0,1) (normal.rs:29)."""
    re = _normal(generator, shape, device)
    return torch.complex(re, _normal(generator, shape, re.device))


def awgn(generator, x, nstd: float, device=None):
    """Add real white Gaussian noise (normal.rs:24)."""
    x = _like(x, device)
    return x + nstd * _normal(generator, x.shape, x.device)


def cawgn(generator, x, nstd: float, device=None):
    """Add complex white Gaussian noise with total σ = nstd (normal.rs:46)."""
    x = _like(x, device)
    return x + (nstd * math.sqrt(0.5)) * crandnf(generator, x.shape, x.device)


def randnf_pdf(x, eta: float, sig: float):
    """N(η,σ²) pdf (normal.rs:51)."""
    if sig <= 0:
        raise ConfigError("standard deviation must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    t = x - eta
    return np.exp(-(t * t) / (2 * sig * sig)) / (sig * np.sqrt(2 * np.pi))


def randnf_cdf(x, eta: float, sig: float):
    """N(η,σ²) cdf (normal.rs:62)."""
    if sig <= 0:
        raise ConfigError("standard deviation must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    return np.vectorize(lambda v: 1.0 - qf((v - eta) / sig))(x)


# -------------------------------------------------------------- exponential
def randexpf(generator, lam: float, shape=(), device=None):
    """Exp(λ) via inverse transform (exp.rs:5)."""
    if lam <= 0:
        raise ConfigError("lambda must be greater than zero")
    return -torch.log(_positive_uniform(generator, shape, device)) / lam


def randexpf_pdf(x, lam: float):
    if lam <= 0:
        raise ConfigError("lambda must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, lam * np.exp(-lam * x), 0.0)


def randexpf_cdf(x, lam: float):
    if lam <= 0:
        raise ConfigError("lambda must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, 1.0 - np.exp(-lam * x), 0.0)


# -------------------------------------------------------------------- gamma
def randgammaf(generator, alpha: float, beta: float, shape=(), device=None):
    """Gamma(α, β) (gamma.rs:5)."""
    if alpha <= 0:
        raise ConfigError("alpha must be greater than zero")
    if beta <= 0:
        raise ConfigError("beta must be greater than zero")
    return beta * _standard_gamma(generator, alpha, shape, device)


def randgammaf_pdf(x, alpha: float, beta: float):
    if alpha <= 0 or beta <= 0:
        raise ConfigError("alpha and beta must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = (
        x[pos] ** (alpha - 1.0)
        * np.exp(-x[pos] / beta)
        / (gammaf(alpha) * beta**alpha)
    )
    return out


def randgammaf_cdf(x, alpha: float, beta: float):
    if alpha <= 0 or beta <= 0:
        raise ConfigError("alpha and beta must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = [lowergammaf(alpha, v / beta) / gammaf(alpha) for v in x[pos]]
    return out


# ---------------------------------------------------------------- Nakagami-m
def randnakmf(generator, m: float, omega: float, shape=(), device=None):
    """Nakagami(m, Ω) = sqrt(Gamma(m, Ω/m)) (nakm.rs:5)."""
    if m < 0.5:
        raise ConfigError("m cannot be less than 0.5")
    if omega <= 0:
        raise ConfigError("omega must be greater than zero")
    return torch.sqrt(randgammaf(generator, m, omega / m, shape, device))


def randnakmf_pdf(x, m: float, omega: float):
    """(nakm.rs:30)."""
    if m < 0.5 or omega <= 0:
        raise ConfigError("invalid m/omega")
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    t = (
        -math.lgamma(m)
        + m * np.log(m / omega)
        + (2 * m - 1) * np.log(x[pos])
        - (m / omega) * x[pos] ** 2
    )
    out[pos] = 2.0 * np.exp(t)
    return out


def randnakmf_cdf(x, m: float, omega: float):
    """γ(m, x²m/Ω)/Γ(m) (nakm.rs:56)."""
    if m < 0.5 or omega <= 0:
        raise ConfigError("invalid m/omega")
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = [lowergammaf(m, v * v * m / omega) / gammaf(m) for v in x[pos]]
    return out


# ------------------------------------------------------------------- Rice-K
def _rice_params(k: float, omega: float):
    s = math.sqrt(omega * k / (k + 1.0))
    sig = math.sqrt(0.5 * omega / (k + 1.0))
    return s, sig


def randricekf(generator, k: float, omega: float, shape=(), device=None):
    """Rice(K, Ω) = |N(s,σ²) + jN(0,σ²)| (ricek.rs:7)."""
    if k < 0:
        raise ConfigError("k must be non-negative")
    if omega <= 0:
        raise ConfigError("omega must be greater than zero")
    s, sig = _rice_params(k, omega)
    z = crandnf(generator, shape, device)
    return torch.complex(z.real * sig + s, z.imag * sig).abs()


def randricekf_pdf(x, k: float, omega: float):
    """(ricek.rs:34)."""
    if k < 0 or omega <= 0:
        raise ConfigError("invalid k/omega")
    x = np.asarray(x, dtype=np.float64)
    s, sig = _rice_params(k, omega)
    sig2 = sig * sig
    out = np.zeros_like(x)
    pos = x >= 0
    xv = x[pos]
    vals = np.zeros_like(xv)
    for i, v in enumerate(xv):
        arg = v * s / sig2
        if arg > 80.0:
            vals[i] = 0.0
        else:
            vals[i] = (v / sig2) * np.exp(-(v * v + s * s) / (2 * sig2)) * besseli0f(arg)
    out[pos] = vals
    return out


def randricekf_cdf(x, k: float, omega: float):
    """1 − Q₁(s/σ, x/σ) (ricek.rs:66)."""
    if k < 0 or omega <= 0:
        raise ConfigError("invalid k/omega")
    x = np.asarray(x, dtype=np.float64)
    s, sig = _rice_params(k, omega)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = [max(0.0, min(1.0, 1.0 - marcumq1f(s / sig, v / sig))) for v in x[pos]]
    return out


# ------------------------------------------------------------------ Weibull
def randweibf(generator, alpha: float, beta: float, gamma: float = 0.0, shape=(),
              device=None):
    """Weibull(α, β) + γ via inverse transform (weib.rs:5)."""
    if alpha <= 0 or beta <= 0:
        raise ConfigError("alpha and beta must be greater than zero")
    u = _positive_uniform(generator, shape, device)
    return gamma + beta * (-torch.log(u)) ** (1.0 / alpha)


def randweibf_pdf(x, alpha: float, beta: float, gamma: float = 0.0):
    """(weib.rs:24)."""
    if alpha <= 0 or beta <= 0:
        raise ConfigError("alpha and beta must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    t = x - gamma
    out = np.zeros_like(x)
    pos = t > 0
    out[pos] = (
        (alpha / beta)
        * (t[pos] / beta) ** (alpha - 1.0)
        * np.exp(-((t[pos] / beta) ** alpha))
    )
    return out


def randweibf_cdf(x, alpha: float, beta: float, gamma: float = 0.0):
    """(weib.rs:40)."""
    if alpha <= 0 or beta <= 0:
        raise ConfigError("alpha and beta must be greater than zero")
    x = np.asarray(x, dtype=np.float64)
    t = x - gamma
    out = np.zeros_like(x)
    pos = t > 0
    out[pos] = 1.0 - np.exp(-((t[pos] / beta) ** alpha))
    return out
