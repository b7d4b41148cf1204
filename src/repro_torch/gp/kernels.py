"""GP covariance kernels (Matérn-5/2 with ARD, RBF).

Counterpart of ``repro/gp/kernels.py``.  On CUDA tensors the Matérn-5/2
covariance of the GP fit (``gram``, ``matern52``) is the hand-written gram
kernel of ``repro_torch.kernels.matern`` (forward K3, gradient in θ K4);
everywhere else, and for the Cholesky posterior, it is plain PyTorch
differentiated by autograd.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import by_study
from repro_torch.kernels.matern.ops import matern52_gram_op

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


def _theta_axes(x: Tensor, lead: int) -> Tensor:
    """Stacked points (S, n, D) against θ with ``lead`` leading dims (S,
    R, ...): singleton axes after S, so study s meets its own θ rows.
    One study's (n, D) broadcast as they are."""
    if x.ndim <= 2 or lead <= x.ndim - 2:
        return x
    return x.reshape(x.shape[:-2] + (1,) * (lead - x.ndim + 2)
                     + x.shape[-2:])


def _sq_dists(x1: Tensor, x2: Tensor, inv_ls: Tensor) -> Tensor:
    """Scaled squared distances, (..., n1, n2). Numerically clamped at 0.

    ``inv_ls`` (..., D) may carry leading θ-batch dimensions (the batched
    MAP fit passes one row per restart); the result then has them too.
    Stacked points (S, n, D) meet θ rows (S, ..., D) study by study.
    """
    lead = inv_ls.ndim - 1
    x1, x2 = _theta_axes(x1, lead), _theta_axes(x2, lead)
    a = x1 * inv_ls[..., None, :]
    b = x2 * inv_ls[..., None, :]
    # ||a-b||^2 = |a|^2 + |b|^2 - 2ab ; clamp negatives from cancellation
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return torch.clamp(d2, min=0.0)


def matern52_plain(x1: Tensor, x2: Tensor, params: KernelParams) -> Tensor:
    """Matérn-5/2 cross covariance in plain PyTorch, (..., n1, n2).

    k(r) = σ_f² (1 + √5 r + 5r²/3) exp(-√5 r),  r = ||(x−x')/ℓ||.
    Differentiable by autograd in every argument; the posterior's
    ``"cholesky"`` backend and the CPU fit use it.  Stacked points (S, n,
    D) go study by study (:func:`by_study`): a batched product rounds
    otherwise than the solo one on the CPU.
    """
    if x1.ndim == 3:
        return by_study(_matern52_plain_one, x1, x2,
                        params.log_lengthscale, params.log_amplitude,
                        stacked=True)
    return _matern52_plain_one(x1, x2, params.log_lengthscale,
                               params.log_amplitude)


def _matern52_plain_one(x1: Tensor, x2: Tensor, log_ls: Tensor,
                        log_amp: Tensor) -> Tensor:
    inv_ls = torch.exp(-log_ls)
    d2 = _sq_dists(x1, x2, inv_ls)
    r = torch.sqrt(d2 + 1e-36)          # eps keeps the gradient finite at r=0
    poly = 1.0 + SQRT5 * r + (5.0 / 3.0) * d2
    return torch.exp(log_amp)[..., None, None] * poly * torch.exp(-SQRT5 * r)


def matern52(x1: Tensor, x2: Tensor, params: KernelParams) -> Tensor:
    """Matérn-5/2 cross covariance, (..., n1, n2), one per θ row of
    ``params`` (log_lengthscale (..., D), log_amplitude (...)).  Stacked
    points x1 (S, n1, D), x2 (S, n2, D) take θ with leading dims (S, ...):
    study s's rows meet its own points (the fleet's study axis).

    On CUDA tensors this is the gram kernel K3, differentiable in θ through
    K4 (``kernels.matern.ops.matern52_gram_op``): one launch for every θ
    row of every study; x1 and x2 then take no gradient.  On the CPU it is
    :func:`matern52_plain`.
    """
    if x1.device.type != "cuda":
        return matern52_plain(x1, x2, params)
    lead = params.log_lengthscale.shape[:-1]
    d = params.log_lengthscale.shape[-1]
    studies = x1.shape[:-2]              # () or (S,)
    inv_ls = torch.exp(-params.log_lengthscale).reshape(studies + (-1, d))
    amp = params.amplitude.reshape(studies + (-1,))
    k = matern52_gram_op(x1, x2, inv_ls, amp)
    return k.reshape(lead + k.shape[-2:])


def rbf(x1: Tensor, x2: Tensor, params: KernelParams) -> Tensor:
    inv_ls = torch.exp(-params.log_lengthscale)
    d2 = _sq_dists(x1, x2, inv_ls)
    return params.amplitude[..., None, None] * torch.exp(-0.5 * d2)


KERNELS = {"matern52": matern52, "rbf": rbf}
# the same covariances without the CUDA kernels: for callers that
# differentiate in x (the Cholesky posterior)
PLAIN_KERNELS = {"matern52": matern52_plain, "rbf": rbf}


def gram(x: Tensor, params: KernelParams, kernel: str = "matern52",
         jitter: float = 1e-8) -> Tensor:
    """Training gram matrix with noise + jitter on the diagonal,
    (..., n, n) for θ rows with leading dimensions (...)."""
    k = KERNELS[kernel](x, x, params)
    n = x.shape[-2]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    return k + (params.noise + jitter)[..., None, None] * eye
