"""Acquisition functions: numerically stable LogEI (Ament et al. 2023), EI,
UCB and the joint q-batch qLogEI, in the state form the MSO layer consumes
and as closures over a fitted GP.

Counterpart of ``repro/core/acquisition.py``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.gp.gpr import GPState, predict, predict_joint

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


AcqBatched = Callable[[Tensor], Tensor]   # (k, D) -> (k,)


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


def _log_softplus(x: Tensor) -> Tensor:
    """log(softplus(x)), stable over all x (→ x for x ≪ 0).  softplus as
    log(1 + eˣ) exactly (``logaddexp``): torch's ``softplus`` returns x
    itself above its threshold, where the reference does not."""
    sp = torch.logaddexp(torch.clamp(x, min=-30.0), torch.zeros_like(x))
    return torch.where(x < -30.0, x, torch.log(sp + 1e-300))


def qlogei_acq(state, xb: Tensor, *, tau_max: float = 1e-2,
               tau_relu: float = 1e-3) -> Tensor:
    """Joint q-batch LogEI: ``state = (GPState, best, eps)``, xb (k, q, D).

    MC qLogEI in the smoothed formulation of Ament et al. 2023: each
    candidate block's joint posterior (``gpr.predict_joint``) is sampled
    with the *fixed* base draws ``eps`` (S, q), common random numbers that
    keep the surface deterministic and differentiable for the QN solvers,
    and the max over the q points and the relu are softened by
    ``logsumexp`` and softplus so gradients reach every batch element:

        qLogEI ≈ log E_s[ τ_r·softplus( τ_m·logsumexp((f_s − best)/τ_m) / τ_r ) ]

    The k blocks are one ``torch.func.vmap`` call (the reference vmaps).
    """
    gp, best, eps = state

    def one(xq: Tensor) -> Tensor:                 # (q, D) -> ()
        mean, cov = predict_joint(gp, xq)
        Lc = torch.linalg.cholesky(cov)
        samples = mean[None, :] + eps @ Lc.T       # (S, q)
        z = samples - best
        smax = tau_max * torch.logsumexp(z / tau_max, dim=-1)
        log_ei_s = math.log(tau_relu) + _log_softplus(smax / tau_relu)
        return torch.logsumexp(log_ei_s, dim=0) - math.log(eps.shape[0])

    return torch.func.vmap(one)(xb)


def qlogei_state(gp: GPState, best, q: int, *, n_samples: int = 64,
                 seed: int = 0):
    """The ``(gp, best, eps)`` state of :func:`qlogei_acq`: ``eps`` (S, q)
    standard normal draws from a ``torch.Generator`` seeded with ``seed``
    (on the CPU, so every device gets the same draws), on the GP's
    device.  The reference draws from ``jax.random``, a stream torch cannot
    reproduce: parity tests hand its draws in as ``eps``."""
    dt, dev = gp.y_train.dtype, gp.y_train.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    eps = torch.randn((n_samples, q), generator=gen, dtype=dt).to(dev)
    return gp, torch.as_tensor(best, dtype=dt, device=dev), eps


def make_logei(gp: GPState, best: float) -> AcqBatched:
    """LogEI closure over a fitted GP (y standardized, maximization
    scale), (k, D) → (k,)."""
    best = torch.as_tensor(best, dtype=gp.y_train.dtype,
                           device=gp.y_train.device)

    def acq(xb: Tensor) -> Tensor:
        mean, var = predict(gp, xb)
        return log_ei(mean, var, best)

    return acq


def make_ucb(gp: GPState, beta: float = 2.0) -> AcqBatched:
    """UCB closure over a fitted GP, (k, D) → (k,)."""
    def acq(xb: Tensor) -> Tensor:
        mean, var = predict(gp, xb)
        return ucb(mean, var, beta)

    return acq
