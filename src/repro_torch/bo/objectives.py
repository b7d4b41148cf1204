"""COCO/BBOB-style benchmark objectives (numpy, black-box side).

The paper's §5 benchmarks: Sphere (f1), Attractive Sector (f6), Step
Ellipsoidal (f7), Rastrigin (rotated, f15) on [-5, 5]^D, plus Rosenbrock for
the off-diagonal-artifact study (§3, Figures 1–5).  Implemented to the BBOB
definitions (T_osz / T_asy / Λ^α / random rotations), seeded per instance.

These are *black-box* objectives: BO only sees f(x); plain numpy.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

DOMAIN = (-5.0, 5.0)


def _rotation(rng: np.random.Generator, d: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((d, d)))
    return q * np.sign(np.diag(r))


def _t_osz(x: np.ndarray) -> np.ndarray:
    xhat = np.where(x != 0, np.log(np.abs(x) + 1e-300), 0.0)
    c1 = np.where(x > 0, 10.0, 5.5)
    c2 = np.where(x > 0, 7.9, 3.1)
    return np.sign(x) * np.exp(
        xhat + 0.049 * (np.sin(c1 * xhat) + np.sin(c2 * xhat)))


def _t_asy(x: np.ndarray, beta: float) -> np.ndarray:
    d = x.shape[-1]
    i = np.arange(d) / max(d - 1, 1)
    expo = 1.0 + beta * i * np.sqrt(np.maximum(x, 0.0))
    return np.where(x > 0, np.power(np.maximum(x, 0.0), expo), x)


def _lam(alpha: float, d: int) -> np.ndarray:
    i = np.arange(d) / max(d - 1, 1)
    return np.power(alpha, 0.5 * i)


class BBOBFunction:
    """Callable objective with instance-seeded optimum/rotations."""

    def __init__(self, name: str, dim: int, seed: int = 1):
        self.name = name
        self.dim = dim
        rng = np.random.default_rng(seed * 1000003 + dim)
        self.x_opt = rng.uniform(-4.0, 4.0, dim)
        self.f_opt = 0.0
        self._R = _rotation(rng, dim)
        self._Q = _rotation(rng, dim)
        self._fn = _FUNCS[name]

    def __call__(self, x: np.ndarray) -> float:
        x = np.asarray(x, np.float64)
        return float(self._fn(self, x) + self.f_opt)

    @property
    def bounds(self):
        return DOMAIN


def _sphere(self: BBOBFunction, x):
    z = x - self.x_opt
    return np.sum(z * z)


def _rastrigin(self: BBOBFunction, x):
    """BBOB f15 (rotated Rastrigin)."""
    z = self._R @ (x - self.x_opt)
    z = _t_asy(_t_osz(z), 0.2)
    z = self._R @ (_lam(10.0, self.dim) * (self._Q @ z))
    return 10.0 * (self.dim - np.sum(np.cos(2 * np.pi * z))) + np.sum(z * z)


def _attractive_sector(self: BBOBFunction, x):
    """BBOB f6."""
    z = self._Q @ (_lam(10.0, self.dim) * (self._R @ (x - self.x_opt)))
    s = np.where(z * self.x_opt > 0, 100.0, 1.0)
    val = np.sum((s * z) ** 2)
    return float(_t_osz(np.asarray([val]))[0]) ** 0.9


def _step_ellipsoidal(self: BBOBFunction, x):
    """BBOB f7."""
    zhat = _lam(10.0, self.dim) * (self._R @ (x - self.x_opt))
    ztilde = np.where(np.abs(zhat) > 0.5,
                      np.floor(0.5 + zhat),
                      np.floor(0.5 + 10.0 * zhat) / 10.0)
    z = self._Q @ ztilde
    i = np.arange(self.dim) / max(self.dim - 1, 1)
    val = np.sum(np.power(10.0, 2.0 * i) * z * z)
    return 0.1 * max(np.abs(zhat[0]) / 1e4, val)


def _rosenbrock(self: BBOBFunction, x):
    """Plain Rosenbrock (the §3 artifact-study objective; optimum at 1)."""
    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                        + (1.0 - x[:-1]) ** 2))


_FUNCS: Dict[str, Callable] = {
    "sphere": _sphere,
    "rastrigin": _rastrigin,
    "attractive_sector": _attractive_sector,
    "step_ellipsoidal": _step_ellipsoidal,
    "rosenbrock": _rosenbrock,
}

OBJECTIVES = tuple(_FUNCS)


def make_objective(name: str, dim: int, seed: int = 1) -> BBOBFunction:
    if name not in _FUNCS:
        raise KeyError(f"unknown objective {name!r}; have {OBJECTIVES}")
    return BBOBFunction(name, dim, seed)
