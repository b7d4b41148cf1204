"""GP hyperparameter fitting: MAP over log-parameters with the package's
own batched L-BFGS-B (``core.lbfgsb``).

Counterpart of ``repro/gp/fit.py``.  Observations are padded to size
buckets with ``_FAR`` pseudo-points, so every consumer sees a handful of
shapes per BO run.  JAX's ``vmap(value_and_grad)`` over the θ restarts is
one batched autograd call here: a batched (R, n, n) gram, one
``torch.linalg.cholesky`` over it, and one ``backward``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lbfgsb import LbfgsbOptions, lbfgsb_minimize
from repro_torch.gp.gpr import (GPState, _cho_solve,
                                log_marginal_likelihood_masked)
from repro_torch.gp.kernels import KernelParams, gram

Tensor = torch.Tensor

# Bounds on the log-hyperparameters (unit-cube-normalized x, standardized y).
LOG_LS_BOUNDS = (-4.0, 4.0)
LOG_AMP_BOUNDS = (-6.0, 6.0)
LOG_NOISE_BOUNDS = (-10.0, 2.0)

PAD_BUCKET = 32
_FAR = 1e6          # padded pseudo-points live this far away (kernel → 0)


def pad_bucket_for(n: int, pad: int) -> int:
    """Smallest pad bucket (multiple of ``pad``) holding ``n`` training
    points; ``pad=0`` disables bucketing."""
    return ((n + pad - 1) // pad) * pad if pad else n


def pack_theta(p: KernelParams) -> Tensor:
    return torch.cat([p.log_lengthscale, p.log_amplitude[None],
                      p.log_noise[None]])


def unpack_theta(theta: Tensor, dim: int) -> KernelParams:
    """(..., P) packed θ → KernelParams with the same leading shape."""
    return KernelParams(log_lengthscale=theta[..., :dim],
                        log_amplitude=theta[..., dim],
                        log_noise=theta[..., dim + 1])


def _neg_map_objective(theta: Tensor, x: Tensor, y: Tensor, valid: Tensor,
                       dim: int, kernel: str) -> Tensor:
    """Negative log posterior of θ, (R,) for a (R, P) batch of θ rows."""
    p = unpack_theta(theta, dim)
    # one gram per row: lengthscales broadcast as (R, 1, D), scalars as
    # (R, 1, 1) against the shared (n, D) training set
    pb = KernelParams(log_lengthscale=p.log_lengthscale[:, None, :],
                      log_amplitude=p.log_amplitude[:, None, None],
                      log_noise=p.log_noise[:, None, None])
    lml = log_marginal_likelihood_masked(x, y, valid, pb, kernel)
    # weak log-normal priors keep the fit away from degenerate corners
    prior = (-0.5 * ((p.log_lengthscale / 2.0) ** 2).sum(-1)
             - 0.5 * (p.log_amplitude / 2.0) ** 2
             - 0.5 * ((p.log_noise + 4.0) / 2.0) ** 2)
    return -(lml + prior)


def fit_padded_core(x, y, valid, thetas, lower, upper, *, dim: int,
                    kernel: str, opts: LbfgsbOptions):
    """Multi-start MAP fit on a padded/masked training set.

    Returns ``(theta_best, chol, alpha, iterations)``.
    """
    def value_and_grad(tb: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            tb = tb.detach().requires_grad_(True)
            f = _neg_map_objective(tb, x, y, valid, dim, kernel)
            # rows are independent, so d(Σf)/dθ_r is row r's gradient
            (g,) = torch.autograd.grad(f.sum(), tb)
        return f.detach(), g

    res = lbfgsb_minimize(value_and_grad, thetas, lower, upper, opts)
    theta_best = res.x[torch.argmin(res.f)]
    p = unpack_theta(theta_best, dim)

    v = valid.to(x.dtype)
    K = gram(x, p, kernel)
    K = K * (v[:, None] * v[None, :]) + torch.diag(1.0 - v)
    L = torch.linalg.cholesky(K)
    alpha = _cho_solve(L, y * v)
    return theta_best, L, alpha, res.k


def theta_bounds(dim: int, dtype=torch.float64,
                 device=None) -> Tuple[Tensor, Tensor]:
    """(lower, upper) box bounds on the packed log-hyperparameters (P,)."""
    def vec(i):
        return torch.tensor([LOG_LS_BOUNDS[i]] * dim
                            + [LOG_AMP_BOUNDS[i], LOG_NOISE_BOUNDS[i]],
                            dtype=dtype, device=device)
    return vec(0), vec(1)


def theta_init_grid(dim: int, dtype, n_restarts: int, seed: int,
                    init: Optional[KernelParams] = None, *,
                    draws: Optional[Tensor] = None,
                    device=None) -> Tensor:
    """(n_restarts, P) multi-start θ inits: the base θ, then base + jitter.

    The jitter is U[-1, 1) from a ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU so every device gets the same inits.
    ``draws`` ((n_restarts-1, P)) replaces those draws, so a caller can
    hand in another stream's numbers (the tests pass the JAX package's).
    """
    base = init if init is not None else KernelParams(
        log_lengthscale=torch.zeros((dim,), dtype=dtype),
        log_amplitude=torch.zeros((), dtype=dtype),
        log_noise=torch.tensor(-4.0, dtype=dtype))
    theta0 = pack_theta(base).to(dtype=dtype, device="cpu")
    P = theta0.shape[0]
    R = max(n_restarts - 1, 0)
    if draws is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        draws = torch.rand((R, P), generator=gen, dtype=dtype) * 2.0 - 1.0
    draws = torch.as_tensor(draws, dtype=dtype).cpu()
    if tuple(draws.shape) != (R, P):
        raise ValueError(f"draws must be {(R, P)}, got {tuple(draws.shape)}")
    grid = torch.cat([theta0[None], theta0[None] + draws], 0)
    return grid.to(device)


FIT_OPTS = LbfgsbOptions(m=10, maxiter=60, pgtol=1e-5, ftol=1e-12)


def fit_gp(
    x: Tensor,
    y: Tensor,
    *,
    kernel: str = "matern52",
    n_restarts: int = 2,
    init: Optional[KernelParams] = None,
    seed: int = 0,
    maxiter: int = 60,
    pad_bucket: int = PAD_BUCKET,
    thetas: Optional[Tensor] = None,
) -> GPState:
    """Fit kernel hyperparameters by MAP (multi-start, batched L-BFGS-B).

    Returns a GPState on the *padded* training set: padded α entries are 0
    and padded points sit at kernel-underflow distance, so ``predict`` is
    exact while every consumer sees one shape per size bucket.
    ``thetas`` ((n_restarts, P)) overrides :func:`theta_init_grid`.
    """
    n, dim = x.shape
    dt, dev = x.dtype, x.device

    n_pad = pad_bucket_for(n, pad_bucket) - n
    if n_pad:
        far = torch.full((n_pad, dim), _FAR, dtype=dt, device=dev) + \
            torch.arange(n_pad, dtype=dt, device=dev)[:, None]
        x = torch.cat([x, far], 0)
        y = torch.cat([y, torch.zeros((n_pad,), dtype=dt, device=dev)], 0)
    valid = torch.arange(n + n_pad, device=dev) < n

    if thetas is None:
        thetas = theta_init_grid(dim, dt, n_restarts, seed, init=init,
                                 device=dev)
    thetas = torch.as_tensor(thetas, dtype=dt, device=dev)
    lower, upper = theta_bounds(dim, dt, dev)

    opts = FIT_OPTS._replace(maxiter=maxiter)
    theta_best, L, alpha, _ = fit_padded_core(
        x, y, valid, thetas, lower.expand(thetas.shape),
        upper.expand(thetas.shape), dim=dim, kernel=kernel, opts=opts)

    return GPState(x_train=x, y_train=y, params=unpack_theta(theta_best, dim),
                   chol=L, alpha=alpha, kernel=kernel)


def standardize(y: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Return (y_std, mean, std): GPSampler-style target standardization."""
    mu = y.mean()
    sd = torch.clamp(y.std(correction=0), min=1e-10)
    return (y - mu) / sd, mu, sd


def standardize_masked(y: Tensor, valid: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Masked :func:`standardize` over a padded target vector; padded
    slots come back exactly 0."""
    v = valid.to(y.dtype)
    n = v.sum()
    mu = (y * v).sum() / n
    sd = torch.clamp(torch.sqrt(((y - mu) ** 2 * v).sum() / n), min=1e-10)
    return torch.where(valid, (y - mu) / sd, 0.0), mu, sd
