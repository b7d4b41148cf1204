"""Plain PyTorch versions of the Matérn-5/2 CUDA kernels.

The CPU path of the kernel wrappers, and what ``chip_smoke.py`` holds the
kernels against on the card.  The formulas are those of
``repro/kernels/matern/ref.py``, in float64.  Each takes the kernel's
optional leading study axis: the gram's x (S, n, D) with θ rows (S, R, D),
the posterior's inputs all leading with S.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import by_study

Tensor = torch.Tensor

SQRT5 = 2.2360679774997896

VAR_FLOOR = 1e-16          # matches gpr.predict's posterior-variance clamp


def _scaled_sq_dists(xq: Tensor, xt: Tensor, inv_lengthscale: Tensor):
    """(a, b, d²) with a leading θ batch from ``inv_lengthscale`` (..., D):
    a (..., q, D), b (..., n, D), d² (..., q, n), clamped at 0."""
    a = xq * inv_lengthscale[..., None, :]
    b = xt * inv_lengthscale[..., None, :]
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return a, b, torch.clamp(d2, min=0.0)


def _theta_axis(x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """Stacked points (S, n, D) get a θ-row axis, (S, 1, n, D), to meet
    θ rows (S, R, D); one study's (n, D) broadcast as they are."""
    if x1.ndim == 3:
        return x1[:, None], x2[:, None]
    return x1, x2


def matern52_gram_ref(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                      amplitude: Tensor) -> Tensor:
    """k(x1, x2): (..., n1, n2).  x*: (n*, D); inv_lengthscale: (..., D);
    amplitude: (...), one gram per θ row (plain version of kernel K3).
    Stacked x* (S, n*, D) take θ rows (S, R, D), (S, R)."""
    x1, x2 = _theta_axis(x1, x2)
    _, _, d2 = _scaled_sq_dists(x1, x2, inv_lengthscale)
    r = torch.sqrt(d2 + 1e-36)
    return amplitude[..., None, None] * \
        (1.0 + SQRT5 * r + (5.0 / 3.0) * d2) * torch.exp(-SQRT5 * r)


def matern52_gram_bwd_theta_ref(x1: Tensor, x2: Tensor,
                                inv_lengthscale: Tensor, amplitude: Tensor,
                                g: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of kernel K4: the gradient of Σ g ⊙ k in (1/ℓ, σ_f²).

        ∂/∂(1/ℓ_rd) = −(5/3)·σ_f²_r·(1/ℓ_rd)
                      · Σ_ij g_rij (1+√5ρ) e^{−√5ρ} (x1_id − x2_jd)²
        ∂/∂σ_f²_r   = Σ_ij g_rij k_rij / σ_f²_r

    x1 (n1, D), x2 (n2, D), inv_lengthscale (R, D), amplitude (R,),
    g (R, n1, n2) → ((R, D), (R,)), or all of them with a leading study
    axis S.  The squared differences are taken in the unscaled
    coordinates, one dimension at a time.
    """
    x1, x2 = _theta_axis(x1, x2)
    _, _, d2 = _scaled_sq_dists(x1, x2, inv_lengthscale)
    r = torch.sqrt(d2 + 1e-36)
    e = torch.exp(-SQRT5 * r)
    d_amp = (g * (1.0 + SQRT5 * r + (5.0 / 3.0) * d2) * e).sum((-1, -2))
    c = g * (1.0 + SQRT5 * r) * e
    s = torch.stack([(c * (x1[..., :, k, None] - x2[..., None, :, k]) ** 2
                      ).sum((-1, -2)) for k in range(x1.shape[-1])], -1)
    return -(5.0 / 3.0) * amplitude[..., None] * inv_lengthscale * s, d_amp


def matern52_posterior_fwd_ref(xq: Tensor, xt: Tensor, alpha: Tensor,
                               kinv: Tensor, inv_lengthscale: Tensor,
                               amplitude: Tensor
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of kernel K1: ((q,) mean, (q,) var, (q, n) t).

    ``t = k* K⁻¹`` is the residual the backward reads.  With a leading
    study axis every input and output leads with S, computed study by
    study (``repro_torch.by_study``: a batched product rounds otherwise
    than the solo one, on the CPU too).
    """
    if xq.ndim == 3:
        return by_study(matern52_posterior_fwd_ref, xq, xt, alpha, kinv,
                        inv_lengthscale, amplitude, stacked=True)
    _, _, d2 = _scaled_sq_dists(xq, xt, inv_lengthscale)
    r = torch.sqrt(d2 + 1e-36)
    k_star = amplitude[..., None, None] * \
        (1.0 + SQRT5 * r + (5.0 / 3.0) * d2) * torch.exp(-SQRT5 * r)
    mean = (k_star @ alpha[..., None])[..., 0]
    t = k_star @ kinv
    quad = (t * k_star).sum(-1)
    var = torch.clamp(amplitude[..., None] - quad, min=VAR_FLOOR)
    return mean, var, t


def matern52_posterior_ref(xq: Tensor, xt: Tensor, alpha: Tensor,
                           kinv: Tensor, inv_lengthscale: Tensor,
                           amplitude: Tensor) -> Tuple[Tensor, Tensor]:
    """Fused GP posterior oracle: ((q,) mean, (q,) variance).

    Quadratic-form formulation: ``mean = k* α``, ``var = σ_f² − k* K⁻¹ k*ᵀ``
    (diagonal), with ``kinv = K⁻¹`` precomputed once per fit.
    Differentiable by autograd in every argument.
    """
    mean, var, _ = matern52_posterior_fwd_ref(xq, xt, alpha, kinv,
                                              inv_lengthscale, amplitude)
    return mean, var


def matern52_posterior_bwd_ref(xq: Tensor, xt: Tensor, alpha: Tensor,
                               t: Tensor, var: Tensor,
                               inv_lengthscale: Tensor, amplitude: Tensor,
                               g_mean: Tensor, g_var: Tensor) -> Tensor:
    """Plain version of kernel K2: ∂(ḡm·mean + ḡv·var)/∂xq, (q, D).

        c_ij   = −(5/3)·σ_f²·(1+√5·r_ij)·exp(−√5·r_ij)
                 · (ḡm_i·α_j − 2·ḡv_i·[var_i > 1e-16]·t_ij)
        ∂/∂xq_i = inv_ls ⊙ ((Σ_j c_ij)·a_i − Σ_j c_ij·b_j)

    with ``a = xq·inv_ls``, ``b = xt·inv_ls`` and ``t = k* K⁻¹`` (K⁻¹
    symmetric, so ∂var/∂k* = −2t).  Stacked inputs go study by study.
    """
    if xq.ndim == 3:
        return by_study(matern52_posterior_bwd_ref, xq, xt, alpha, t, var,
                        inv_lengthscale, amplitude, g_mean, g_var,
                        stacked=True)
    a, b, d2 = _scaled_sq_dists(xq, xt, inv_lengthscale)
    r = torch.sqrt(d2 + 1e-36)
    gv = torch.where(var > VAR_FLOOR, g_var, 0.0)
    w = g_mean[..., :, None] * alpha[..., None, :] - 2.0 * gv[..., :, None] * t
    c = -(5.0 / 3.0) * amplitude[..., None, None] * (1.0 + SQRT5 * r) * \
        torch.exp(-SQRT5 * r) * w                                  # (q, n)
    return inv_lengthscale[..., None, :] * (c.sum(-1, keepdim=True) * a
                                            - c @ b)
