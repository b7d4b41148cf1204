"""Differentiable fused Matérn-5/2 posterior over the CUDA kernels.

``matern52_posterior_op`` is the evaluation engine's hot path.  Its
forward launches K1 and keeps ``t = k* K⁻¹`` and ``var`` as residuals; its
backward launches K2, so neither direction runs the plain version on the
card.  CPU tensors take the plain versions (the wrappers route by device).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.matern.kernel import (matern52_posterior_bwd_xq,
                                               matern52_posterior_fwd)

Tensor = torch.Tensor


class _PosteriorFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, xt, alpha, kinv, inv_lengthscale, amplitude):
        mean, var, t = matern52_posterior_fwd(xq, xt, alpha, kinv,
                                              inv_lengthscale, amplitude)
        ctx.save_for_backward(xq, xt, alpha, t, var, inv_lengthscale,
                              amplitude)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        if any(ctx.needs_input_grad[1:]):
            raise NotImplementedError(
                "matern52_posterior_op differentiates in xq only")
        xq, xt, alpha, t, var, inv_ls, amp = ctx.saved_tensors
        g_mean = (torch.zeros_like(var) if g_mean is None
                  else g_mean.contiguous())
        g_var = (torch.zeros_like(var) if g_var is None
                 else g_var.contiguous())
        dxq = matern52_posterior_bwd_xq(xq, xt, alpha, t, var, inv_ls, amp,
                                        g_mean, g_var)
        return dxq, None, None, None, None, None


def matern52_posterior_op(xq: Tensor, xt: Tensor, alpha: Tensor,
                          kinv: Tensor, inv_lengthscale: Tensor,
                          amplitude: Tensor) -> Tuple[Tensor, Tensor]:
    """Fused GP posterior ((q,) mean, (q,) var), differentiable in ``xq``.

    ``kinv`` is the precomputed K⁻¹ of the training gram.  On the card
    every input must be contiguous (``gp.gpr.with_kinv`` builds a row-major
    K⁻¹); the kernel wrappers raise on anything else rather than copy.
    """
    return _PosteriorFn.apply(xq, xt, alpha, kinv, inv_lengthscale,
                              amplitude)
