"""Box search space with unit-cube normalization (GPSampler convention:
the GP and the acquisition optimization always live on [0, 1]^D)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoxSpace:
    lower: np.ndarray      # (D,)
    upper: np.ndarray      # (D,)

    def __post_init__(self):
        object.__setattr__(self, "lower", np.asarray(self.lower, np.float64))
        object.__setattr__(self, "upper", np.asarray(self.upper, np.float64))
        if self.lower.shape != self.upper.shape:
            raise ValueError("bound shapes differ")
        if np.any(self.lower >= self.upper):
            raise ValueError("lower must be < upper elementwise")

    @property
    def dim(self) -> int:
        return self.lower.shape[0]

    @classmethod
    def cube(cls, dim: int, lo: float, hi: float) -> "BoxSpace":
        return cls(np.full(dim, lo), np.full(dim, hi))

    def to_unit(self, x: np.ndarray) -> np.ndarray:
        return (x - self.lower) / (self.upper - self.lower)

    def from_unit(self, u: np.ndarray) -> np.ndarray:
        return self.lower + u * (self.upper - self.lower)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.uniform(self.lower, self.upper, (n, self.dim))
