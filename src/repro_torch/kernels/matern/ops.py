"""Differentiable Matérn-5/2 ops over the CUDA kernels.

``matern52_posterior_op`` is the evaluation engine's hot path.  Its
forward launches K1 and keeps ``t = k* K⁻¹`` and ``var`` as residuals; its
backward launches K2, so neither direction runs the plain version on the
card.

``matern52_gram_op`` is the GP fit's gram: forward K3 for a batch of θ
rows, backward K4 in (1/ℓ, σ_f²).  ``matern52_cross`` is one θ row of it
(JAX's ``matern52_cross``).

CPU tensors take the plain versions (the wrappers route by device).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.matern.kernel import (matern52_gram_bwd_theta,
                                               matern52_gram_fwd,
                                               matern52_posterior_bwd_xq,
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


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, inv_lengthscale, amplitude):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError("matern52_gram_op differentiates in "
                             "(inv_lengthscale, amplitude) only; x1 and x2 "
                             "must not require grad")
        ctx.save_for_backward(x1, x2, inv_lengthscale, amplitude)
        return matern52_gram_fwd(x1, x2, inv_lengthscale, amplitude)

    @staticmethod
    def backward(ctx, g):
        x1, x2, inv_ls, amp = ctx.saved_tensors
        d_inv, d_amp = matern52_gram_bwd_theta(x1, x2, inv_ls, amp,
                                               g.contiguous())
        return None, None, d_inv, d_amp


def matern52_gram_op(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                     amplitude: Tensor) -> Tensor:
    """(R, n1, n2) Matérn-5/2 grams of x1 (n1, D) against x2 (n2, D), one
    per θ row of ``inv_lengthscale`` (R, D) and ``amplitude`` (R,);
    differentiable in those two only (raises if x1 or x2 requires grad).
    On the card every input must be contiguous."""
    return _GramFn.apply(x1, x2, inv_lengthscale, amplitude)


def matern52_cross(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                   amplitude: Tensor) -> Tensor:
    """(n1, n2) cross-gram at one θ: ``inv_lengthscale`` (D,),
    ``amplitude`` ()."""
    return matern52_gram_op(x1, x2, inv_lengthscale[None],
                            amplitude.reshape(1))[0]
