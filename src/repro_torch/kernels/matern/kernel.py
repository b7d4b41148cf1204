"""CUDA kernels of the fused Matérn-5/2 posterior: build, binding, wrappers.

``csrc/posterior.cu`` holds the two kernels (see its header for what they
replace, what bounds them and why they look as they do):

* :func:`matern52_posterior_fwd` (K1): mean, variance and the residual
  ``t = k* K⁻¹`` of a (q, D) query batch;
* :func:`matern52_posterior_bwd_xq` (K2): the gradient in the queries.

The source is compiled with ``nvcc`` into a shared library with a plain C
interface at first use, into ``build/kernels/`` at the repository root,
and loaded with ``ctypes``.  Nothing is built or imported at module import.

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU,
and only for those.  For CUDA tensors it checks device, dtype (float64),
shape and contiguity, allocates its outputs, launches on the current
stream, raises if the launch fails, and adds one to its launch count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.matern.ref import (matern52_posterior_bwd_ref,
                                            matern52_posterior_fwd_ref)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "posterior.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

MAX_SMEM = 232448                 # dynamic shared memory a block may use

# launches of each kernel; read and reset by callers that must show the
# main path went through the kernels (chip_smoke.py, EvalEngine stats)
LAUNCHES: Dict[str, int] = {"matern52_posterior_fwd": 0,
                            "matern52_posterior_bwd_xq": 0}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/posterior.cu`` (if not already built) and return the
    library's path.  The file name carries a hash of the source and flags,
    so an edited source is rebuilt."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmatern_posterior_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.matern52_posterior_fwd.argtypes = [p] * 9 + [i] * 4 + [p]
            lib.matern52_posterior_fwd.restype = i
            lib.matern52_posterior_bwd_xq.argtypes = [p] * 10 + [i] * 3 + [p]
            lib.matern52_posterior_bwd_xq.restype = i
            _LIB = lib
    return _LIB


def _check(name: str, x: Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float64:
        raise TypeError(f"{name} must be float64, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def rows_per_block(q: int, n: int, d: int, n_sm: int) -> int:
    """Query rows per block of K1: enough to put at most one block per SM
    when q is large (each K⁻¹ load then serves more rows), at most 8, and
    within the shared memory a block may use."""
    rows = 1
    while rows < 8 and rows * n_sm < q:
        rows *= 2
    while rows > 1 and 8 * (rows * n + rows * d + rows + 8) > MAX_SMEM:
        rows //= 2
    if 8 * (rows * n + rows * d + rows + 8) > MAX_SMEM:
        raise ValueError(f"n={n} training points do not fit the forward "
                         f"kernel's shared memory")
    return rows


def matern52_posterior_fwd(xq: Tensor, xt: Tensor, alpha: Tensor,
                           kinv: Tensor, inv_lengthscale: Tensor,
                           amplitude: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ((q,) mean, (q,) var, (q, n) t = k* K⁻¹)."""
    if _on_cpu(xq):
        return matern52_posterior_fwd_ref(xq, xt, alpha, kinv,
                                          inv_lengthscale, amplitude)
    q, d = xq.shape
    n = xt.shape[0]
    dev = xq.device
    for name, x, shape in (("xq", xq, (q, d)), ("xt", xt, (n, d)),
                           ("alpha", alpha, (n,)), ("kinv", kinv, (n, n)),
                           ("inv_lengthscale", inv_lengthscale, (d,)),
                           ("amplitude", amplitude, ())):
        _check(name, x, shape, dev)
    if q < 1 or n < 1:
        raise ValueError(f"empty posterior input (q={q}, n={n})")
    rows = rows_per_block(
        q, n, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    mean = torch.empty((q,), dtype=torch.float64, device=dev)
    var = torch.empty((q,), dtype=torch.float64, device=dev)
    t = torch.empty((q, n), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_posterior_fwd(
            xq.data_ptr(), xt.data_ptr(), alpha.data_ptr(), kinv.data_ptr(),
            inv_lengthscale.data_ptr(), amplitude.data_ptr(),
            mean.data_ptr(), var.data_ptr(), t.data_ptr(), q, n, d, rows,
            stream)
    if err != 0:
        raise RuntimeError(f"matern52_posterior_fwd launch failed: "
                           f"cudaError {err}")
    LAUNCHES["matern52_posterior_fwd"] += 1
    return mean, var, t


def matern52_posterior_bwd_xq(xq: Tensor, xt: Tensor, alpha: Tensor,
                              t: Tensor, var: Tensor,
                              inv_lengthscale: Tensor, amplitude: Tensor,
                              g_mean: Tensor, g_var: Tensor) -> Tensor:
    """K2: ∂(ḡm·mean + ḡv·var)/∂xq, (q, D)."""
    if _on_cpu(xq):
        return matern52_posterior_bwd_ref(xq, xt, alpha, t, var,
                                          inv_lengthscale, amplitude,
                                          g_mean, g_var)
    q, d = xq.shape
    n = xt.shape[0]
    dev = xq.device
    for name, x, shape in (("xq", xq, (q, d)), ("xt", xt, (n, d)),
                           ("alpha", alpha, (n,)), ("t", t, (q, n)),
                           ("var", var, (q,)),
                           ("inv_lengthscale", inv_lengthscale, (d,)),
                           ("amplitude", amplitude, ()),
                           ("g_mean", g_mean, (q,)), ("g_var", g_var, (q,))):
        _check(name, x, shape, dev)
    if 8 * (n + d + 9) > MAX_SMEM:
        raise ValueError(f"n={n} training points do not fit the backward "
                         f"kernel's shared memory")
    dxq = torch.empty((q, d), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_posterior_bwd_xq(
            xq.data_ptr(), xt.data_ptr(), alpha.data_ptr(), t.data_ptr(),
            var.data_ptr(), inv_lengthscale.data_ptr(), amplitude.data_ptr(),
            g_mean.data_ptr(), g_var.data_ptr(), dxq.data_ptr(), q, n, d,
            stream)
    if err != 0:
        raise RuntimeError(f"matern52_posterior_bwd_xq launch failed: "
                           f"cudaError {err}")
    LAUNCHES["matern52_posterior_bwd_xq"] += 1
    return dxq
