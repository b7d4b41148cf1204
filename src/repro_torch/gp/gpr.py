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

from repro_torch.gp.kernels import PLAIN_KERNELS, KernelParams, gram

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
    n = gp.x_train.shape[0]
    eye = torch.eye(n, dtype=gp.chol.dtype, device=gp.chol.device)
    # cholesky_solve may hand back column-major strides; the kernels (and
    # every round of the MSO) want K⁻¹ row-major, so pay the copy once here
    kinv = _cho_solve(gp.chol, eye).contiguous()
    return GPState(x_train=gp.x_train, y_train=gp.y_train, params=gp.params,
                   chol=gp.chol, alpha=gp.alpha, kernel=gp.kernel,
                   kinv=kinv)


def _one_hot(idx: int, n: int, like: Tensor) -> Tensor:
    e = torch.zeros((n,), dtype=like.dtype, device=like.device)
    e[idx] = 1.0
    return e


def cholesky_update(chol: Tensor, k_col: Tensor, k_diag: Tensor,
                    idx: int) -> Tuple[Tensor, Tensor]:
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
    """
    z = torch.linalg.solve_triangular(chol, k_col[:, None], upper=False)[:, 0]
    s = k_diag - z @ z
    l22 = torch.sqrt(torch.clamp(s, min=1e-300))
    e = _one_hot(idx, chol.shape[0], chol)
    # z is zero at idx (masked k_col ⇒ identity block solves to 0), so the
    # new row is z with l22 dropped onto the diagonal
    row = z + l22 * e
    chol_new = chol * (1.0 - e)[:, None] + e[:, None] * row[None, :]
    return chol_new, s


def kinv_update(kinv: Tensor, k_col: Tensor, s: Tensor, idx: int) -> Tensor:
    """Bordered-inverse append matching :func:`cholesky_update`, O(n²).

    With ``w = K⁻¹k`` (padded: zero at slots ≥ idx) and Schur complement
    ``s``, the blockwise inverse of the grown matrix, in the padded layout
    (identity at pad slots, including the old entry at ``idx``), is one
    symmetric rank-one correction: ``K⁻¹ + (w−e)(w−e)ᵀ/s − eeᵀ``.
    Functional, and row-major like :func:`with_kinv`'s.
    """
    w = kinv @ k_col
    e = _one_hot(idx, kinv.shape[0], kinv)
    t = w - e
    return kinv + torch.outer(t, t) / s - torch.outer(e, e)


def predict(gp: GPState, x_query: Tensor) -> Tuple[Tensor, Tensor]:
    """Posterior mean and variance at (q, D) query points → ((q,), (q,)).

    One batched call for all q points: the 'Batched Evaluation' of
    Algorithm 1.  The cross gram (q, n) is built once and the triangular
    solve batches over q.
    """
    # plain torch: autograd differentiates it in the queries
    kfn = PLAIN_KERNELS[gp.kernel]
    k_star = kfn(x_query, gp.x_train, gp.params)          # (q, n)
    mean = k_star @ gp.alpha                              # O(q·n)
    v = torch.linalg.solve_triangular(gp.chol, k_star.T, upper=False)
    prior = gp.params.amplitude
    var = torch.clamp(prior - (v * v).sum(0), min=1e-16)
    return mean, var


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
    """
    v = valid.to(x.dtype)
    K = gram(x, params, kernel, jitter)
    mask2 = v[:, None] * v[None, :]
    K = K * mask2 + torch.diag(1.0 - v)
    yv = y * v
    L = torch.linalg.cholesky(K)
    alpha = _cho_solve(L, yv.expand(L.shape[:-1]))
    n_valid = v.sum()
    logdiag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    return (-0.5 * (yv * alpha).sum(-1)
            - (logdiag * v).sum(-1)
            - 0.5 * n_valid * _LOG_2PI)


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
