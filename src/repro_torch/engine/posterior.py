"""Posterior backends for the evaluation engine.

Counterpart of ``repro/engine/posterior.py``.  The dominant per-round cost
of MSO is the batched GP posterior (paper §4).  This module routes it:

* ``"cholesky"`` — ``gp.gpr.predict``: cross-gram + triangular solve,
  differentiable by autograd, runs anywhere (JAX's ``"xla"``);
* ``"fused"``    — the quadratic-form op over the CUDA kernels K1/K2
  (``kernels.matern.ops``; JAX's ``"pallas"``); on CPU tensors it runs
  the kernels' plain versions;
* ``"auto"``     — ``"fused"`` on CUDA, ``"cholesky"`` on the CPU.

The fused path needs ``GPState.kinv`` (``gp.gpr.with_kinv``).  Unlike the
reference, a state without it raises instead of quietly taking the
Cholesky path, so nothing can skip the kernel unseen.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.acquisition import log_ei
from repro_torch.gp.gpr import GPState, predict
from repro_torch.kernels.matern.ops import matern52_posterior_op

Tensor = torch.Tensor

BACKENDS = ("auto", "cholesky", "fused")


def resolve_backend(backend: str = "auto", device=None) -> str:
    """Concrete backend for ``device`` (``"auto"`` → fused on CUDA)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    if backend == "auto":
        dev = torch.device("cuda" if device is None else device)
        return "fused" if dev.type == "cuda" else "cholesky"
    return backend


def posterior(gp: GPState, xb: Tensor, *, backend: str = "auto"
              ) -> Tuple[Tensor, Tensor]:
    """Batched posterior ((k,) mean, (k,) var) via the chosen backend."""
    backend = resolve_backend(backend, xb.device)
    if backend == "cholesky":
        return predict(gp, xb)
    if gp.kernel != "matern52":
        raise ValueError(f"the fused posterior is Matérn-5/2 only, "
                         f"got kernel {gp.kernel!r}")
    if gp.kinv is None:
        raise ValueError("the fused posterior needs GPState.kinv; "
                         "build it with gp.gpr.with_kinv")
    inv_ls = torch.exp(-gp.params.log_lengthscale)
    return matern52_posterior_op(xb, gp.x_train, gp.alpha, gp.kinv, inv_ls,
                                 gp.params.amplitude)


# one acq function object per backend, so an engine built for one keeps
# evaluating the same function
_LOGEI_CACHE: Dict[str, Callable] = {}


def fused_logei_acq(backend: str = "auto") -> Callable:
    """State-form LogEI (``state = (GPState, best)``) over the chosen
    posterior backend: drop-in for ``core.acquisition.logei_acq``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}")
    fn = _LOGEI_CACHE.get(backend)
    if fn is None:
        def acq(state, xb, _backend=backend):
            gp, best = state
            mean, var = posterior(gp, xb, backend=_backend)
            return log_ei(mean, var, best)
        acq.__name__ = f"logei_acq_{backend}"
        _LOGEI_CACHE[backend] = fn = acq
    return fn
