"""Acquisition functions: numerically stable LogEI (Ament et al. 2023), EI
and UCB, in the state form the MSO layer consumes.

Counterpart of ``repro/core/acquisition.py`` (qLogEI comes with a later
slice).
"""
from __future__ import annotations

import math

import torch

from repro_torch.gp.gpr import predict

Tensor = torch.Tensor

_C1 = 0.5 * math.log(2.0 * math.pi)          # log √(2π)
_SQRT2 = math.sqrt(2.0)


def _log_phi(z):
    return -0.5 * z * z - _C1


_BRANCH = -25.0     # direct f64 eval is cancellation-safe above this


def log_h(z: Tensor) -> Tensor:
    """log(φ(z) + z·Φ(z)): the LogEI kernel, stable over all z.

    Branches (double-where guarded so gradients stay finite: a ``where``
    whose unselected branch is inf or NaN poisons the gradient):
      z > -25  : direct  log(φ(z) + zΦ(z));
      z ≤ -25  : asymptotic from Φ(z) ~ φ(z)/(−z)·Σ(−1)ᵏ(2k−1)!!/z²ᵏ:
                 log h = log φ − 2·log|z| + log1p(−3u + 15u² − 105u³),
                 u = 1/z².
    """
    z_safe_hi = torch.clamp(z, min=_BRANCH)       # direct-branch input
    phi = torch.exp(_log_phi(z_safe_hi))
    # erfc keeps Φ relatively accurate in the far tail
    Phi = 0.5 * torch.special.erfc(-z_safe_hi / _SQRT2)
    direct_arg = torch.clamp(phi + z_safe_hi * Phi, min=1e-300)
    direct = torch.log(direct_arg)

    z_safe_lo = torch.clamp(z, max=_BRANCH)       # asymptotic-branch input
    u = 1.0 / (z_safe_lo * z_safe_lo)
    asym = (_log_phi(z_safe_lo) - 2.0 * torch.log(-z_safe_lo)
            + torch.log1p(-3.0 * u + 15.0 * u * u - 105.0 * u * u * u))
    return torch.where(z > _BRANCH, direct, asym)


def log_ei(mean: Tensor, var: Tensor, best) -> Tensor:
    """log E[max(0, μ − best)] under N(μ, σ²), maximization convention."""
    sigma = torch.sqrt(var)
    z = (mean - best) / sigma
    return log_h(z) + 0.5 * torch.log(var)


def ei(mean: Tensor, var: Tensor, best) -> Tensor:
    sigma = torch.sqrt(var)
    z = (mean - best) / sigma
    phi = torch.exp(_log_phi(z))
    Phi = 0.5 * torch.special.erfc(-z / _SQRT2)
    return sigma * (phi + z * Phi)


def ucb(mean: Tensor, var: Tensor, beta: float = 2.0) -> Tensor:
    return mean + beta * torch.sqrt(var)


def logei_acq(state, xb: Tensor) -> Tensor:
    """State-form LogEI for the MSO layer: ``state = (GPState, best)``."""
    gp, best = state
    mean, var = predict(gp, xb)
    return log_ei(mean, var, best)


def ucb_acq(state, xb: Tensor) -> Tensor:
    """State-form UCB: ``state = (GPState, beta)``."""
    gp, beta = state
    mean, var = predict(gp, xb)
    return mean + beta * torch.sqrt(var)
