"""CUDA kernels of the Matérn-5/2 GP: build, binding, wrappers.

``csrc/posterior.cu`` holds the fused posterior (see its header for what
the kernels replace, what bounds them and why they look as they do):

* :func:`matern52_posterior_fwd` (K1): mean, variance and the residual
  ``t = k* K⁻¹`` of a (q, D) query batch;
* :func:`matern52_posterior_bwd_xq` (K2): the gradient in the queries.

``csrc/gram.cu`` holds the gram matrix of the GP fit:

* :func:`matern52_gram_fwd` (K3): the (R, n1, n2) cross-gram for R θ rows;
* :func:`matern52_gram_bwd_theta` (K4): its gradient in (1/ℓ, σ_f²).

At first use each source is compiled with its own ``nvcc`` (both run at
once) and the objects are linked into one shared library with a plain C
interface, in ``build/kernels/`` at the repository root, loaded with
``ctypes``.
Nothing is built or imported at module import.

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

from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                            matern52_gram_ref,
                                            matern52_posterior_bwd_ref,
                                            matern52_posterior_fwd_ref)

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "posterior.cu", CSRC / "gram.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

MAX_SMEM = 232448                 # dynamic shared memory a block may use

# launches of each kernel; read and reset by callers that must show the
# main path went through the kernels (chip_smoke.py, EvalEngine stats)
LAUNCHES: Dict[str, int] = {"matern52_posterior_fwd": 0,
                            "matern52_posterior_bwd_xq": 0,
                            "matern52_gram_fwd": 0,
                            "matern52_gram_bwd_theta": 0}

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


def _lib_path() -> Path:
    """The library's file; its name carries a hash of the sources and
    flags, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmatern_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile each source to an object, one ``nvcc`` each, all started
    together, and link the objects into one shared library (if not built
    yet); return its path."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
        elif verbose and stderr:
            print(stderr)
    objs = [str(obj) for _, obj, _ in procs]
    if not failed:
        tmp = BUILD_DIR / f"{stem}.so"
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"nvcc link failed ({link.returncode}):\n"
                          f"{link.stdout}\n{link.stderr}")
        else:
            os.replace(tmp, out)
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            lib.matern52_posterior_fwd.argtypes = [p] * 9 + [i] * 4 + [p]
            lib.matern52_posterior_fwd.restype = i
            lib.matern52_posterior_bwd_xq.argtypes = [p] * 10 + [i] * 3 + [p]
            lib.matern52_posterior_bwd_xq.restype = i
            lib.matern52_gram_smem_bytes.argtypes = [i, i]
            lib.matern52_gram_smem_bytes.restype = z
            lib.matern52_gram_bwd_scratch.argtypes = [i] * 4
            lib.matern52_gram_bwd_scratch.restype = z
            lib.matern52_gram_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.matern52_gram_fwd.restype = i
            lib.matern52_gram_bwd_theta.argtypes = [p] * 8 + [i] * 4 + [p]
            lib.matern52_gram_bwd_theta.restype = i
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


def _gram_dims(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
               amplitude: Tensor) -> Tuple[int, int, int, int]:
    if x1.ndim != 2 or x2.ndim != 2 or inv_lengthscale.ndim != 2:
        raise ValueError("gram kernels take x1 (n1, D), x2 (n2, D), "
                         "inv_lengthscale (R, D), amplitude (R,)")
    r, d = inv_lengthscale.shape
    n1, n2 = x1.shape[0], x2.shape[0]
    dev = x1.device
    for name, x, shape in (("x1", x1, (n1, d)), ("x2", x2, (n2, d)),
                           ("inv_lengthscale", inv_lengthscale, (r, d)),
                           ("amplitude", amplitude, (r,))):
        _check(name, x, shape, dev)
    if min(r, n1, n2, d) < 1:
        raise ValueError(f"empty gram input (R={r}, n1={n1}, n2={n2}, D={d})")
    return r, n1, n2, d


def _gram_smem(d: int, backward: bool) -> None:
    need = _lib().matern52_gram_smem_bytes(d, int(backward))
    if need > MAX_SMEM:
        raise ValueError(f"D={d} does not fit the gram kernels' shared "
                         f"memory ({need} > {MAX_SMEM} bytes)")


def matern52_gram_fwd(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                      amplitude: Tensor) -> Tensor:
    """K3: k(x1, x2) for each of R θ rows, (R, n1, n2)."""
    if _on_cpu(x1):
        return matern52_gram_ref(x1, x2, inv_lengthscale, amplitude)
    r, n1, n2, d = _gram_dims(x1, x2, inv_lengthscale, amplitude)
    _gram_smem(d, backward=False)
    dev = x1.device
    out = torch.empty((r, n1, n2), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_gram_fwd(
            x1.data_ptr(), x2.data_ptr(), inv_lengthscale.data_ptr(),
            amplitude.data_ptr(), out.data_ptr(), r, n1, n2, d, stream)
    if err != 0:
        raise RuntimeError(f"matern52_gram_fwd launch failed: "
                           f"cudaError {err}")
    LAUNCHES["matern52_gram_fwd"] += 1
    return out


def matern52_gram_bwd_theta(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                            amplitude: Tensor, g: Tensor
                            ) -> Tuple[Tensor, Tensor]:
    """K4: (∂/∂(1/ℓ) (R, D), ∂/∂σ_f² (R,)) of Σ g ⊙ K3(x1, x2, 1/ℓ, σ_f²)."""
    if _on_cpu(x1):
        return matern52_gram_bwd_theta_ref(x1, x2, inv_lengthscale,
                                           amplitude, g)
    r, n1, n2, d = _gram_dims(x1, x2, inv_lengthscale, amplitude)
    dev = x1.device
    _check("g", g, (r, n1, n2), dev)
    _gram_smem(d, backward=True)
    lib = _lib()
    partial = torch.empty((lib.matern52_gram_bwd_scratch(r, n1, n2, d),),
                          dtype=torch.float64, device=dev)
    d_inv = torch.empty((r, d), dtype=torch.float64, device=dev)
    d_amp = torch.empty((r,), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.matern52_gram_bwd_theta(
            x1.data_ptr(), x2.data_ptr(), inv_lengthscale.data_ptr(),
            amplitude.data_ptr(), g.data_ptr(), partial.data_ptr(),
            d_inv.data_ptr(), d_amp.data_ptr(), r, n1, n2, d, stream)
    if err != 0:
        raise RuntimeError(f"matern52_gram_bwd_theta launch failed: "
                           f"cudaError {err}")
    LAUNCHES["matern52_gram_bwd_theta"] += 1
    return d_inv, d_amp
