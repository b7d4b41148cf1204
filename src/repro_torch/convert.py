"""Build the port's :class:`~repro_torch.gp.gpr.GPState` from numpy arrays.

Lets both packages compute on one fitted GP: the caller turns the other
package's state into numpy arrays (``np.asarray``) and hands them here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.gp.gpr import GPState
from repro_torch.gp.kernels import KernelParams


def gp_state_from_numpy(*, x_train, y_train, log_lengthscale, log_amplitude,
                        log_noise, chol, alpha, kinv=None,
                        kernel: str = "matern52",
                        device=None) -> GPState:
    """float64 GPState on ``device`` (default CPU) from numpy arrays."""
    dev = torch.device("cpu" if device is None else device)

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float64, copy=True)).to(dev)

    kinv_t: Optional[torch.Tensor] = None if kinv is None else t(kinv)
    params = KernelParams(log_lengthscale=t(log_lengthscale),
                          log_amplitude=t(log_amplitude),
                          log_noise=t(log_noise))
    return GPState(x_train=t(x_train), y_train=t(y_train), params=params,
                   chol=t(chol), alpha=t(alpha), kernel=kernel, kinv=kinv_t)
