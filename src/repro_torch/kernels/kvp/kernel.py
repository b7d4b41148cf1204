"""CUDA kernel-vector product (GP posterior mean): build, binding, wrapper.

``csrc/kvp.cu`` holds K5 ``kvp_fwd`` (see its header for what it
replaces, what bounds it and why it looks as it does).  It is built with
the port's other kernels into one library at first use
(``kernels/_build.py``); nothing is built at import.

:func:`kvp_fwd` takes the plain version (``ref.py``) for tensors on the
CPU, and only for those.  For CUDA tensors it checks device, dtype
(float64), shape and contiguity, allocates the output, launches on the
current stream, raises if the launch fails, and adds one to its launch
count.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import (MAX_SMEM, check_launch,
                                        check_tensor, declare, on_cpu)
from repro_torch.kernels._build import lib as _lib
from repro_torch.kernels.kvp.ref import kvp_ref

Tensor = torch.Tensor

# launches of K5; read and reset by callers that must show a path went
# through the kernel (chip_smoke.py)
LAUNCHES: Dict[str, int] = {"kvp_fwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
declare("kvp_smem_bytes", [_I], ctypes.c_size_t)
declare("kvp_fwd", [_P] * 6 + [_I] * 3 + [_P], _I)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def kvp_fwd(xq: Tensor, xt: Tensor, alpha: Tensor, inv_lengthscale: Tensor,
            amplitude: Tensor) -> Tensor:
    """K5: (q,) = matern52(xq, xt) @ alpha, float64.  xq (q, D), xt (n, D),
    alpha (n,), inv_lengthscale (D,), amplitude ()."""
    if on_cpu(xq):
        return kvp_ref(xq, xt, alpha, inv_lengthscale, amplitude)
    if xq.ndim != 2 or xt.ndim != 2:
        raise ValueError("kvp takes xq (q, D) and xt (n, D)")
    q, d = xq.shape
    n = xt.shape[0]
    dev = xq.device
    for name, x, shape in (("xq", xq, (q, d)), ("xt", xt, (n, d)),
                           ("alpha", alpha, (n,)),
                           ("inv_lengthscale", inv_lengthscale, (d,)),
                           ("amplitude", amplitude, ())):
        check_tensor(name, x, shape, torch.float64, dev)
    out = torch.empty((q,), dtype=torch.float64, device=dev)
    if d < 1 or _lib().kvp_smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"D={d} does not fit the kvp kernel's shared memory")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().kvp_fwd(xq.data_ptr(), xt.data_ptr(), alpha.data_ptr(),
                             inv_lengthscale.data_ptr(), amplitude.data_ptr(),
                             out.data_ptr(), q, n, d, stream)
    check_launch("kvp_fwd", err)
    LAUNCHES["kvp_fwd"] += 1
    return out
