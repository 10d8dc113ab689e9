"""Genetic-algorithm search over packed-bit chromosomes (host-side).

Copied from :mod:`yagi_tpu.optim.gasearch` (liquid-dsp's ``gasearch`` and
``chromosome`` objects), with the same seeded ``np.random.default_rng``, so
the two packages' searches agree draw for draw.

liquid's model: a :class:`Chromosome` is an array of traits, each an
unsigned integer of ``bits_per_trait[i]`` bits; ``valuef(i)`` maps trait i
linearly onto [0,1]. The GA keeps a sorted population, clones/crossovers
from the top half, and mutates at a configured rate.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..errors import ConfigError
from .qs1dsearch import OptimDirection

__all__ = ["Chromosome", "GaSearch"]


class Chromosome:
    """Packed multi-trait bit string (liquid chromosome)."""

    def __init__(self, bits_per_trait: Sequence[int]):
        bits = [int(b) for b in bits_per_trait]
        if not bits or any(b < 1 or b > 64 for b in bits):
            raise ConfigError("bits per trait must each be in [1,64]")
        self.bits_per_trait = bits
        self.num_traits = len(bits)
        self.num_bits = sum(bits)
        self.traits = np.zeros(self.num_traits, dtype=np.uint64)

    @classmethod
    def create_basic(cls, num_traits: int, bits_per_trait: int) -> "Chromosome":
        return cls([bits_per_trait] * num_traits)

    def copy(self) -> "Chromosome":
        c = Chromosome(self.bits_per_trait)
        c.traits = self.traits.copy()
        return c

    def init_random(self, rng: np.random.Generator) -> None:
        for i, b in enumerate(self.bits_per_trait):
            self.traits[i] = rng.integers(0, 1 << b, dtype=np.uint64)

    def value(self, i: int) -> int:
        """Integer trait value."""
        return int(self.traits[i])

    def valuef(self, i: int) -> float:
        """Trait mapped linearly onto [0,1] (liquid chromosome_valuef)."""
        b = self.bits_per_trait[i]
        return int(self.traits[i]) / float((1 << b) - 1)

    def set_valuef(self, i: int, v: float) -> None:
        b = self.bits_per_trait[i]
        self.traits[i] = np.uint64(round(min(max(v, 0.0), 1.0) * ((1 << b) - 1)))

    def mutate(self, bit_index: int) -> None:
        """Flip one bit of the concatenated bit string (chromosome_mutate)."""
        if not 0 <= bit_index < self.num_bits:
            raise ConfigError("bit index out of range")
        for i, b in enumerate(self.bits_per_trait):
            if bit_index < b:
                self.traits[i] ^= np.uint64(1) << np.uint64(b - 1 - bit_index)
                return
            bit_index -= b

    def crossover(self, other: "Chromosome", threshold: int) -> "Chromosome":
        """Single-point crossover: bits [0,threshold) from self, rest from
        other (chromosome_crossover)."""
        if self.bits_per_trait != other.bits_per_trait:
            raise ConfigError("chromosome layouts differ")
        child = self.copy()
        pos = 0
        for i, b in enumerate(self.bits_per_trait):
            if threshold <= pos:
                child.traits[i] = other.traits[i]
            elif threshold < pos + b:
                k = threshold - pos  # bits kept from self (MSB side)
                keep_mask = np.uint64(((1 << k) - 1) << (b - k)) if k else np.uint64(0)
                child.traits[i] = (self.traits[i] & keep_mask) | (
                    other.traits[i] & ~keep_mask & np.uint64((1 << b) - 1)
                )
            pos += b
        return child


class GaSearch:
    """Elitist genetic-algorithm search (liquid gasearch)."""

    def __init__(
        self,
        utility: Callable[[Chromosome], float],
        prototype: Chromosome,
        direction: OptimDirection = OptimDirection.MAXIMIZE,
        population_size: int = 32,
        mutation_rate: float = 0.1,
        seed: int = 0,
    ):
        if population_size < 4:
            raise ConfigError("population size must be at least 4")
        if not 0.0 <= mutation_rate <= 1.0:
            raise ConfigError("mutation rate must be in [0,1]")
        self.utility = utility
        self.direction = direction
        self.population_size = int(population_size)
        self.mutation_rate = float(mutation_rate)
        self.rng = np.random.default_rng(seed)
        self.population: list[Chromosome] = []
        for _ in range(self.population_size):
            c = prototype.copy()
            c.init_random(self.rng)
            self.population.append(c)
        self._rank()
        self.num_generations = 0

    def _fitness(self, c: Chromosome) -> float:
        u = float(self.utility(c))
        return u if self.direction == OptimDirection.MAXIMIZE else -u

    def _rank(self) -> None:
        self.population.sort(key=self._fitness, reverse=True)

    @property
    def best(self) -> Chromosome:
        return self.population[0]

    @property
    def best_utility(self) -> float:
        return float(self.utility(self.population[0]))

    def evolve(self) -> float:
        """One generation: keep the elite half, refill via crossover of two
        elite parents + per-bit mutation. Returns the best utility."""
        n_elite = self.population_size // 2
        new_pop = [c.copy() for c in self.population[:n_elite]]
        while len(new_pop) < self.population_size:
            i, j = self.rng.integers(0, n_elite, size=2)
            child = self.population[int(i)].crossover(
                self.population[int(j)],
                int(self.rng.integers(0, self.population[0].num_bits + 1)),
            )
            n_mut = self.rng.binomial(child.num_bits, self.mutation_rate)
            for _ in range(n_mut):
                child.mutate(int(self.rng.integers(0, child.num_bits)))
            new_pop.append(child)
        self.population = new_pop
        self._rank()
        self.num_generations += 1
        return self.best_utility

    def run(self, generations: int) -> Chromosome:
        for _ in range(generations):
            self.evolve()
        return self.best
