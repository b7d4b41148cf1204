"""Build the port's GP and fused-ask state from numpy arrays.

Lets both packages compute on one fitted GP, or take one incremental ask
step from one state: the caller turns the other package's state into
numpy arrays (``np.asarray``) and hands them here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.engine.ask import AskConfig, AskEngine
from repro_torch.engine.engine import EvalEngine
from repro_torch.gp.gpr import GPState
from repro_torch.gp.kernels import KernelParams


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64, copy=True)).to(dev)


def gp_state_from_numpy(*, x_train, y_train, log_lengthscale, log_amplitude,
                        log_noise, chol, alpha, kinv=None,
                        kernel: str = "matern52",
                        device=None) -> GPState:
    """float64 GPState on ``device`` (default CPU) from numpy arrays."""
    dev = torch.device("cpu" if device is None else device)

    def t(a) -> torch.Tensor:
        return _tensor(a, dev)

    kinv_t: Optional[torch.Tensor] = None if kinv is None else t(kinv)
    params = KernelParams(log_lengthscale=t(log_lengthscale),
                          log_amplitude=t(log_amplitude),
                          log_noise=t(log_noise))
    return GPState(x_train=t(x_train), y_train=t(y_train), params=params,
                   chol=t(chol), alpha=t(alpha), kernel=kernel, kinv=kinv_t)


def ask_engine_from_numpy(engine: EvalEngine, cfg: AskConfig, *, x, y, n: int,
                          n_fit: int, theta, chol, alpha, kinv=None,
                          since_refit: int = 0) -> AskEngine:
    """An :class:`AskEngine` on ``engine.device`` holding a fitted state.

    ``x`` (b, D) and ``y`` (b,) are the padded observation buffers with
    ``n`` live rows; ``theta`` (P,), ``chol``, ``alpha`` and ``kinv``
    (fused backend) describe the fit over the first ``n_fit`` of them.
    With ``n == n_fit + 1`` the next ``suggest()`` is incremental (while
    ``since_refit < cfg.refit_interval - 1``).
    """
    dev = engine.device
    ask = AskEngine(engine, cfg)
    ask._x, ask._y = _tensor(x, dev), _tensor(y, dev)
    ask._n, ask._n_fit, ask._since_refit = int(n), int(n_fit), since_refit
    ask._theta, ask._chol = _tensor(theta, dev), _tensor(chol, dev)
    ask._alpha = _tensor(alpha, dev)
    ask._kinv = None if kinv is None else _tensor(kinv, dev)
    return ask
