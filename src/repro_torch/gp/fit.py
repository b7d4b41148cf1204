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
from repro_torch import by_study
from repro_torch.gp.gpr import (GPState, _cho_solve, cholesky_update,
                                kinv_update, log_marginal_likelihood_masked)
from repro_torch.gp.kernels import KERNELS, KernelParams, gram

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
    # one (n, n) gram per θ row: on the card one K3 launch for all R rows
    # forward, one K4 launch backward
    lml = log_marginal_likelihood_masked(x, y, valid, p, kernel)
    # weak log-normal priors keep the fit away from degenerate corners;
    # the sum over D in an order fixed by D (batch-invariant)
    prior = (-0.5 * _tree_sum((p.log_lengthscale / 2.0) ** 2)
             - 0.5 * (p.log_amplitude / 2.0) ** 2
             - 0.5 * ((p.log_noise + 4.0) / 2.0) ** 2)
    return -(lml + prior)


def fit_padded_core(x, y, valid, thetas, lower, upper, *, dim: int,
                    kernel: str, opts: LbfgsbOptions):
    """Multi-start MAP fit on a padded/masked training set.

    Returns ``(theta_best, chol, alpha, iterations, rounds)``: ``rounds``
    is the number of batched objective evaluations (one value-and-gradient
    over all restarts each), a count the reference does not return.

    Stacked studies (the fleet): x (S, b, D), y and valid (S, b), θ inits
    and bounds (S, R, P).  Every study's restarts run in one lockstep
    solve, so an evaluation is one gram (on the card one K3 and one K4
    launch) for all S·R rows; the result leads with S.  The Cholesky
    factorizations, solves and sums run study by study
    (``repro_torch.by_study``), so a study's fit is bitwise its solo fit.
    """
    def value_and_grad(tb: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            tb = tb.detach().requires_grad_(True)
            f = _neg_map_objective(tb, x, y, valid, dim, kernel)
            # rows are independent, so d(Σf)/dθ_r is row r's gradient
            (g,) = torch.autograd.grad(f.sum(), tb)
        return f.detach(), g

    res = lbfgsb_minimize(value_and_grad, thetas, lower, upper, opts)
    best = torch.argmin(res.f, dim=-1, keepdim=True)         # (..., 1)
    theta_best = torch.take_along_dim(res.x, best[..., None], -2)[..., 0, :]
    p = unpack_theta(theta_best, dim)

    v = valid.to(x.dtype)
    K = gram(x, p, kernel)
    K = K * (v[..., :, None] * v[..., None, :]) + torch.diag_embed(1.0 - v)
    L, alpha = by_study(_chol_alpha, K, y * v, stacked=x.ndim == 3)
    return theta_best, L, alpha, res.k, res.rounds


def _chol_alpha(K: Tensor, yv: Tensor) -> Tuple[Tensor, Tensor]:
    L = torch.linalg.cholesky(K)
    return L, _cho_solve(L, yv)


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
    theta_best, L, alpha, _, _ = fit_padded_core(
        x, y, valid, thetas, lower.expand(thetas.shape),
        upper.expand(thetas.shape), dim=dim, kernel=kernel, opts=opts)

    return GPState(x_train=x, y_train=y, params=unpack_theta(theta_best, dim),
                   chol=L, alpha=alpha, kernel=kernel)


def standardize(y: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Return (y_std, mean, std): GPSampler-style target standardization."""
    mu = y.mean()
    sd = torch.clamp(y.std(correction=0), min=1e-10)
    return (y - mu) / sd, mu, sd


def _tree_sum(x: Tensor) -> Tensor:
    """Σ over the last axis in a pairwise order fixed by its length alone:
    zero-padded to a power of two, the halves added until one is left.
    Elementwise adds only, so a row's sum has the same bits whatever the
    leading shape, on any device; a CUDA ``sum`` picks its order from the
    whole tensor's shape, so a study's moments would round otherwise in a
    fleet block than alone."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def standardize_masked(y: Tensor, valid: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Masked :func:`standardize` over a padded target vector; padded
    slots come back exactly 0.  Stacked targets (S, b) with masks (S, b)
    standardize each row on its own moments, bitwise those of the row
    alone (:func:`_tree_sum`)."""
    v = valid.to(y.dtype)
    n = v.sum(-1, keepdim=True)          # a count: exact in any order
    mu = _tree_sum(y * v)[..., None] / n
    sd = torch.clamp(torch.sqrt(_tree_sum((y - mu) ** 2 * v)[..., None]
                                / n), min=1e-10)
    return torch.where(valid, (y - mu) / sd, 0.0), mu[..., 0], sd[..., 0]


def incremental_update(
    x: Tensor,
    y_std: Tensor,
    n_valid,
    params: KernelParams,
    chol: Tensor,
    kinv: Optional[Tensor] = None,
    *,
    kernel: str = "matern52",
    jitter: float = 1e-8,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Tensor]:
    """O(n²) trial-to-trial GP refit: fixed θ, one appended observation.

    ``chol`` (and optionally ``kinv``) describe the previous trial's
    padded fit over the first ``n_valid − 1`` rows of ``x``; the new
    observation sits at row ``n_valid − 1`` (inside the same pad bucket).
    Rank-one-updates the Cholesky factor / K⁻¹ and re-solves α for the
    (re-standardized) targets: no refactorization, no MAP optimization.
    The cross column k(x_new, X) is one K3 launch on the card.

    Returns ``(chol, alpha, kinv, ok)`` (new tensors; the inputs are left
    as they were).  ``ok`` (a bool tensor) is False for a numerically
    impossible Schur complement: callers must then fall back to a full
    refit.

    Stacked studies (the fleet): x (S, b, D), y_std (S, b), params and
    factors leading with S, and ``n_valid`` an (S,) integer tensor, each
    slot's own count; the cross columns are one K3 launch for all S, the
    triangular solves and products study by study (``repro_torch.by_study``).
    """
    b = x.shape[-2]
    idx = torch.as_tensor(n_valid, device=x.device) - 1
    dt = x.dtype
    valid_old = (torch.arange(b, device=x.device) < idx[..., None]).to(dt)
    # each slot's new row, (..., 1, D)
    x_new = torch.take_along_dim(x, idx[..., None, None], -2)
    k_col = KERNELS[kernel](x_new, x, params)[..., 0, :] * valid_old
    k_diag = params.amplitude + params.noise + jitter
    chol_new, s, alpha, kinv_new = by_study(
        _append_one, chol, k_col, k_diag, idx, y_std, kinv,
        stacked=x.ndim == 3)
    ok = torch.isfinite(s) & (s > 1e-12 * k_diag)
    return chol_new, alpha, kinv_new, ok


def _append_one(chol, k_col, k_diag, idx, y_std, kinv):
    """One study's rank-one append (see :func:`incremental_update`)."""
    chol_new, s = cholesky_update(chol, k_col, k_diag, idx)
    # y re-standardizes every trial (mean/std shift), so α is fresh either
    # way, but the solve on the updated factor is O(n²), not O(n³)
    alpha = _cho_solve(chol_new, y_std)
    kinv_new = None if kinv is None else kinv_update(kinv, k_col, s, idx)
    return chol_new, s, alpha, kinv_new
