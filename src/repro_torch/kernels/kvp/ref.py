"""Plain PyTorch version of the kernel-vector product K5.

The CPU path of the kernel wrapper, and what ``chip_smoke.py`` holds the
kernel against on the card: ``repro/kernels/kvp/ref.py::kvp_ref`` in
float64, through the port's Matérn-5/2 gram.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matern.ref import matern52_gram_ref

Tensor = torch.Tensor


def kvp_ref(xq: Tensor, xt: Tensor, alpha: Tensor, inv_lengthscale: Tensor,
            amplitude: Tensor) -> Tensor:
    """GP posterior-mean kernel-vector product: (q,) = k(xq, xt) @ alpha."""
    return matern52_gram_ref(xq, xt, inv_lengthscale, amplitude) @ alpha
