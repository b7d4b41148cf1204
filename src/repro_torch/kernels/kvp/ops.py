"""Public op: GP posterior mean k(xq, xt) @ α with backend dispatch.

Counterpart of ``repro/kernels/kvp/ops.py``.  Backends: ``"plain"`` (JAX's
``"xla"``, also accepted) is the plain version; ``"fused"`` (JAX's
``"pallas"``) is kernel K5 on CUDA tensors (its wrapper takes the plain
version for CPU tensors); ``"auto"`` is K5 on CUDA tensors and the plain
version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kvp.kernel import kvp_fwd
from repro_torch.kernels.kvp.ref import kvp_ref

Tensor = torch.Tensor

BACKENDS = ("auto", "fused", "plain", "xla")


def gp_mean_kvp(xq: Tensor, xt: Tensor, alpha: Tensor,
                inv_lengthscale: Tensor, amplitude: Tensor, *,
                backend: str = "auto") -> Tensor:
    """(q,) posterior mean of a GP with training points ``xt`` and
    ``alpha = K⁻¹ y`` at queries ``xq``, float64."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend in ("plain", "xla") or (backend == "auto"
                                       and xq.device.type == "cpu"):
        return kvp_ref(xq, xt, alpha, inv_lengthscale, amplitude)
    return kvp_fwd(xq, xt, alpha, inv_lengthscale, amplitude)
