"""GP covariance kernels (Matérn-5/2 with ARD, RBF) in plain PyTorch.

Counterpart of ``repro/gp/kernels.py``.  These are the covariances of the
GP fit (built with autograd in θ) and of the Cholesky posterior; the fused
posterior kernel lives in ``repro_torch.kernels.matern``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor

SQRT5 = 2.2360679774997896


@dataclass
class KernelParams:
    """Log-parameterized (unconstrained) ARD kernel hyperparameters."""
    log_lengthscale: Tensor   # (D,)
    log_amplitude: Tensor     # ()  log σ_f²  (variance, not std)
    log_noise: Tensor         # ()  log σ_n²

    @property
    def lengthscale(self) -> Tensor:
        return torch.exp(self.log_lengthscale)

    @property
    def amplitude(self) -> Tensor:
        return torch.exp(self.log_amplitude)

    @property
    def noise(self) -> Tensor:
        return torch.exp(self.log_noise)


def init_params(dim: int, dtype=torch.float64, device=None) -> KernelParams:
    return KernelParams(
        log_lengthscale=torch.zeros((dim,), dtype=dtype, device=device),
        log_amplitude=torch.zeros((), dtype=dtype, device=device),
        log_noise=torch.tensor(-4.0, dtype=dtype, device=device),
    )


def _sq_dists(x1: Tensor, x2: Tensor, inv_ls: Tensor) -> Tensor:
    """Scaled squared distances, (..., n1, n2). Numerically clamped at 0.

    Leading batch dimensions broadcast (the batched MAP fit passes
    ``inv_ls`` of shape (R, 1, D) against ``x`` of shape (n, D)).
    """
    a = x1 * inv_ls
    b = x2 * inv_ls
    # ||a-b||^2 = |a|^2 + |b|^2 - 2ab ; clamp negatives from cancellation
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return torch.clamp(d2, min=0.0)


def matern52(x1: Tensor, x2: Tensor, params: KernelParams) -> Tensor:
    """Matérn-5/2 cross covariance, (n1, n2).

    k(r) = σ_f² (1 + √5 r + 5r²/3) exp(-√5 r),  r = ||(x−x')/ℓ||.
    """
    inv_ls = torch.exp(-params.log_lengthscale)
    d2 = _sq_dists(x1, x2, inv_ls)
    r = torch.sqrt(d2 + 1e-36)          # eps keeps the gradient finite at r=0
    poly = 1.0 + SQRT5 * r + (5.0 / 3.0) * d2
    return params.amplitude * poly * torch.exp(-SQRT5 * r)


def rbf(x1: Tensor, x2: Tensor, params: KernelParams) -> Tensor:
    inv_ls = torch.exp(-params.log_lengthscale)
    d2 = _sq_dists(x1, x2, inv_ls)
    return params.amplitude * torch.exp(-0.5 * d2)


KERNELS = {"matern52": matern52, "rbf": rbf}


def gram(x: Tensor, params: KernelParams, kernel: str = "matern52",
         jitter: float = 1e-8) -> Tensor:
    """Training gram matrix with noise + jitter on the diagonal."""
    k = KERNELS[kernel](x, x, params)
    n = x.shape[0]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    return k + (params.noise + jitter) * eye
