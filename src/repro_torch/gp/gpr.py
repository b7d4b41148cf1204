"""Gaussian-process regression: Cholesky posterior + marginal likelihood.

Counterpart of ``repro/gp/gpr.py``.  The per-evaluation cost O(n² + nD)
of :func:`predict` is the quantity the paper's cost model (§4) says
dominates MSO, which is why batching B query points into one call (one
(B, n) cross-kernel + one triangular solve with B right-hand sides) is
where D-BE's speedup comes from.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import by_study
from repro_torch.gp.kernels import KERNELS, PLAIN_KERNELS, KernelParams, gram

Tensor = torch.Tensor

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class GPState:
    """Fitted-GP state: everything :func:`predict` needs.

    All tensors are detached and live on one device.  ``kinv`` (K⁻¹,
    optional) backs the fused quadratic-form posterior kernel; build it
    with :func:`with_kinv`.
    """
    x_train: Tensor       # (n, D)
    y_train: Tensor       # (n,)  (standardized)
    params: KernelParams
    chol: Tensor          # (n, n) lower Cholesky of K + (σ_n²+jitter) I
    alpha: Tensor         # (n,)   K⁻¹ y
    kernel: str = "matern52"
    kinv: Optional[Tensor] = None   # (n, n) K⁻¹ for the fused posterior

    @property
    def device(self) -> torch.device:
        return self.x_train.device


def _cho_solve(L: Tensor, b: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = b for a vector or a matrix right-hand side."""
    if b.ndim == L.ndim - 1:
        return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.cholesky_solve(b, L)


def kinv_from_chol(L: Tensor) -> Tensor:
    """K⁻¹ from a Cholesky factor (..., n, n), row-major."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    # cholesky_solve may hand back column-major strides; the kernels (and
    # every round of the MSO) want K⁻¹ row-major, so pay the copy once here
    return _cho_solve(L, eye.expand(L.shape)).contiguous()


def fit_gram(x: Tensor, y: Tensor, params: KernelParams,
             kernel: str = "matern52", jitter: float = 1e-8) -> GPState:
    K = gram(x, params, kernel, jitter)
    L = torch.linalg.cholesky(K)
    alpha = _cho_solve(L, y)
    return GPState(x_train=x, y_train=y, params=params, chol=L,
                   alpha=alpha, kernel=kernel)


def with_kinv(gp: GPState) -> GPState:
    """Materialize K⁻¹ from the Cholesky factor (no-op if present).

    One extra O(n³) triangular solve pair per fit, the same order as the
    Cholesky itself, in exchange for a posterior variance that is a pure
    quadratic form: what the fused posterior kernel consumes.
    """
    if gp.kinv is not None:
        return gp
    kinv = kinv_from_chol(gp.chol)
    return GPState(x_train=gp.x_train, y_train=gp.y_train, params=gp.params,
                   chol=gp.chol, alpha=gp.alpha, kernel=gp.kernel,
                   kinv=kinv)


def _one_hot(idx, n: int, like: Tensor) -> Tensor:
    """(..., n) one-hot rows at ``idx``: an int, or an integer tensor of
    per-slot indices (...,) (the fleet's stacked studies)."""
    idx = torch.as_tensor(idx, device=like.device)
    return (torch.arange(n, device=like.device) == idx[..., None]).to(
        like.dtype)


def cholesky_update(chol: Tensor, k_col: Tensor, k_diag: Tensor,
                    idx) -> Tuple[Tensor, Tensor]:
    """Rank-one *append* update of a padded Cholesky factor, O(n²).

    ``chol`` is the (b, b) lower factor of ``blockdiag(K_n, I_pad)`` (the
    padded-fit layout: identity rows for pad slots).  A new observation
    enters at row ``idx`` (== n, the first pad slot); ``k_col`` is its
    masked cross-covariance against the b rows (zero at slots ≥ idx) and
    ``k_diag`` its prior variance + noise + jitter.  The bordered update

        l₁₂ = L⁻¹ k,   l₂₂ = √(k_diag − ‖l₁₂‖²)

    replaces the identity row at ``idx``, so the result is again
    blockdiag-padded.  Functional: ``chol`` is left as it was.

    Returns ``(chol_new, s)`` with ``s = k_diag − ‖l₁₂‖²`` the Schur
    complement: ``s ≤ 0`` (numerically impossible K) signals the caller
    to fall back to a full refit.

    Stacked: ``chol`` (S, b, b), ``k_col`` (S, b), ``k_diag`` (S,) and
    ``idx`` an (S,) tensor (each slot's own row) update S factors at once.
    """
    z = torch.linalg.solve_triangular(chol, k_col[..., None],
                                      upper=False)[..., 0]
    s = k_diag - (z * z).sum(-1)
    l22 = torch.sqrt(torch.clamp(s, min=1e-300))
    e = _one_hot(idx, chol.shape[-1], chol)
    # z is zero at idx (masked k_col ⇒ identity block solves to 0), so the
    # new row is z with l22 dropped onto the diagonal
    row = z + l22[..., None] * e
    chol_new = (chol * (1.0 - e)[..., :, None]
                + e[..., :, None] * row[..., None, :])
    return chol_new, s


def kinv_update(kinv: Tensor, k_col: Tensor, s: Tensor, idx) -> Tensor:
    """Bordered-inverse append matching :func:`cholesky_update`, O(n²).

    With ``w = K⁻¹k`` (padded: zero at slots ≥ idx) and Schur complement
    ``s``, the blockwise inverse of the grown matrix, in the padded layout
    (identity at pad slots, including the old entry at ``idx``), is one
    symmetric rank-one correction: ``K⁻¹ + (w−e)(w−e)ᵀ/s − eeᵀ``.
    Functional, and row-major like :func:`with_kinv`'s.  Stacked like
    :func:`cholesky_update` (per-slot ``idx``).
    """
    w = (kinv @ k_col[..., None])[..., 0]
    e = _one_hot(idx, kinv.shape[-1], kinv)
    t = w - e
    return (kinv + t[..., :, None] * t[..., None, :] / s[..., None, None]
            - e[..., :, None] * e[..., None, :])


def predict(gp: GPState, x_query: Tensor) -> Tuple[Tensor, Tensor]:
    """Posterior mean and variance at (q, D) query points → ((q,), (q,)).

    One batched call for all q points: the 'Batched Evaluation' of
    Algorithm 1.  The cross gram (q, n) is built once and the triangular
    solve batches over q.  A stacked state (every tensor leading with S,
    the fleet's studies) takes (S, q, D) queries → ((S, q), (S, q)),
    study by study (:func:`by_study`).
    """
    return by_study(_predict_one, gp.x_train, gp.params.log_lengthscale,
                    gp.params.log_amplitude, gp.params.log_noise, gp.chol,
                    gp.alpha, x_query, gp.kernel,
                    stacked=gp.x_train.ndim == 3)


def _predict_one(x_train, log_ls, log_amp, log_noise, chol, alpha,
                 x_query, kernel):
    # plain torch: autograd differentiates it in the queries
    params = KernelParams(log_ls, log_amp, log_noise)
    k_star = PLAIN_KERNELS[kernel](x_query, x_train, params)     # (q, n)
    mean = (k_star @ alpha[..., None])[..., 0]                  # O(q·n)
    v = torch.linalg.solve_triangular(chol, k_star.transpose(-1, -2),
                                      upper=False)
    var = torch.clamp(params.amplitude[..., None] - (v * v).sum(-2),
                      min=1e-16)
    return mean, var


def predict_joint(gp: GPState, x_query: Tensor, jitter: float = 1e-10
                  ) -> Tuple[Tensor, Tensor]:
    """Joint posterior over a q-batch: ((q,) mean, (q, q) covariance).

    The q-batch acquisition (joint qLogEI) needs the cross-candidate
    covariances, not only the diagonal :func:`predict` returns; with a
    stacked state (leading S) the queries are (S, q, D) and the results
    ((S, q), (S, q, q)), study by study.  Both cross grams are the plain
    Matérn under autograd, as :func:`predict` is, on every device: the
    gradient in ``x_query`` is one the gram kernel K3 does not give (its
    op differentiates in θ only), so on the card too this is plain
    PyTorch, not a kernel.
    """
    return by_study(_predict_joint_one, gp.x_train,
                    gp.params.log_lengthscale, gp.params.log_amplitude,
                    gp.params.log_noise, gp.chol, gp.alpha, x_query,
                    gp.kernel, jitter, stacked=gp.x_train.ndim == 3)


def _predict_joint_one(x_train, log_ls, log_amp, log_noise, chol, alpha,
                       x_query, kernel, jitter):
    params = KernelParams(log_ls, log_amp, log_noise)
    kfn = PLAIN_KERNELS[kernel]
    k_star = kfn(x_query, x_train, params)                      # (q, n)
    mean = k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.transpose(-1, -2),
                                      upper=False)              # (n, q)
    cov = kfn(x_query, x_query, params) - v.transpose(-1, -2) @ v
    q = x_query.shape[-2]
    return mean, cov + jitter * torch.eye(q, dtype=cov.dtype,
                                          device=cov.device)


def log_marginal_likelihood(x: Tensor, y: Tensor, params: KernelParams,
                            kernel: str = "matern52",
                            jitter: float = 1e-8) -> Tensor:
    """log p(y | X, θ): the GP-fit objective (maximized)."""
    n = x.shape[0]
    K = gram(x, params, kernel, jitter)
    L = torch.linalg.cholesky(K)
    alpha = _cho_solve(L, y)
    return (-0.5 * (y * alpha).sum(-1)
            - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * n * _LOG_2PI)


def log_marginal_likelihood_masked(x: Tensor, y: Tensor, valid: Tensor,
                                   params: KernelParams,
                                   kernel: str = "matern52",
                                   jitter: float = 1e-8) -> Tensor:
    """Masked LML over a padded training set.

    Rows with ``valid == 0`` are replaced by unit-variance independent
    pseudo-observations of 0: the padded gram is ``blockdiag(K_valid, I)``
    and ``y`` is zeroed there, so the result equals the exact LML of the
    valid subset.  The params may carry leading batch dimensions (one θ
    per row, as in the batched MAP fit); the result then has them too.
    Stacked studies: x (S, b, D), y and valid (S, b) with params leading
    (S, R) give (S, R), each study's rows over its own data and bitwise
    the study alone (:func:`by_study`).
    """
    v = valid.to(x.dtype)
    # one (b, b) covariance per θ row of every study: on the card one K3
    # launch forward and one K4 backward; the rest study by study
    k = KERNELS[kernel](x, x, params)
    return by_study(_lml_masked_one, k, y, v, params.noise + jitter,
                    stacked=x.ndim == 3)


def _lml_masked_one(k: Tensor, y: Tensor, v: Tensor,
                    noise: Tensor) -> Tensor:
    """One study's masked LML from its covariances k ((..., b, b), one per
    θ row), targets y (b,), mask v (b,) and noise + jitter (...)."""
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    K = k + noise[..., None, None] * eye
    K = K * (v[:, None] * v[None, :]) + torch.diag(1.0 - v)
    yv = y * v
    L = torch.linalg.cholesky(K)
    alpha = _cho_solve(L, yv.expand(L.shape[:-1]))
    logdiag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    return (-0.5 * (yv * alpha).sum(-1)
            - (logdiag * v).sum(-1)
            - 0.5 * v.sum(-1) * _LOG_2PI)


def pad_gp(gp: GPState, multiple: int = 32) -> GPState:
    """Pad the training set to a multiple of ``multiple`` rows.

    Exactness: padded α entries are 0, so the mean is unchanged; the
    Cholesky factor (and K⁻¹) extend block-diagonally with I, and the
    padded cross-kernel columns are zero because the fake points sit at a
    1e6 offset where Matérn/RBF underflow to 0, so the variance is
    unchanged too.
    """
    n, d = gp.x_train.shape
    n_pad = (-n) % multiple
    if n_pad == 0:
        return gp
    dt, dev = gp.x_train.dtype, gp.x_train.device
    far = torch.full((n_pad, d), 1e6, dtype=dt, device=dev) + \
        torch.arange(n_pad, dtype=dt, device=dev)[:, None]
    x_p = torch.cat([gp.x_train, far], 0)
    zeros = torch.zeros((n_pad,), dtype=dt, device=dev)
    y_p = torch.cat([gp.y_train, zeros], 0)
    alpha_p = torch.cat([gp.alpha, zeros], 0)

    def blockdiag(m: Tensor) -> Tensor:
        out = torch.zeros((n + n_pad, n + n_pad), dtype=dt, device=dev)
        out[:n, :n] = m
        out[n:, n:] = torch.eye(n_pad, dtype=dt, device=dev)
        return out

    kinv_p = None if gp.kinv is None else blockdiag(gp.kinv)
    return GPState(x_train=x_p, y_train=y_p, params=gp.params,
                   chol=blockdiag(gp.chol), alpha=alpha_p, kernel=gp.kernel,
                   kinv=kinv_p)
