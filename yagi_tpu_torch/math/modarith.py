"""Modular arithmetic utilities (host-side Python ints).

Copied from :mod:`yagi_tpu.math.modarith` (the reference's math/modarith.rs).
"""

from __future__ import annotations

import math

from ..errors import ConfigError, ValueRangeError

__all__ = [
    "is_prime",
    "factor",
    "unique_factor",
    "gcd",
    "modpow",
    "primitive_root_prime",
    "totient",
]


def is_prime(n: int) -> bool:
    """Primality test (modarith.rs:14)."""
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def factor(n: int) -> list[int]:
    """Prime factorization with multiplicity (modarith.rs:47)."""
    if n < 2:
        raise ValueRangeError("factor: input must be > 1")
    factors = []
    d = 2
    x = n
    while d * d <= x:
        while x % d == 0:
            factors.append(d)
            x //= d
        d += 1
    if x > 1:
        factors.append(x)
    return factors


def unique_factor(n: int) -> list[int]:
    """Distinct prime factors (modarith.rs:82)."""
    out: list[int] = []
    for f in factor(n):
        if not out or out[-1] != f:
            out.append(f)
    return out


def gcd(p: int, q: int) -> int:
    """Greatest common divisor (modarith.rs:119)."""
    if p == 0 or q == 0:
        raise ConfigError("gcd: inputs must be non-zero")
    return math.gcd(p, q)


def modpow(base: int, exp: int, n: int) -> int:
    """base^exp mod n (modarith.rs:157)."""
    return pow(base, exp, n)


def primitive_root_prime(n: int) -> int:
    """Smallest primitive root of prime n (modarith.rs:187)."""
    if not is_prime(n):
        raise ConfigError("primitive_root_prime: input must be prime")
    phi = n - 1
    prime_factors = unique_factor(phi) if phi > 1 else []
    for g in range(2, n):
        if all(modpow(g, phi // f, n) != 1 for f in prime_factors):
            return g
    raise ConfigError("primitive_root_prime: no root found")


def totient(x: int) -> int:
    """Euler's totient (modarith.rs:224)."""
    n = x
    result = x
    p = 2
    while p * p <= n:
        if n % p == 0:
            while n % p == 0:
                n //= p
            result -= result // p
        p += 1
    if n > 1:
        result -= result // n
    return result
