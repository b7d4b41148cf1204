"""Build and load the port's CUDA kernels: one library from every source.

Every ``kernels/*/csrc/*.cu`` of the port is compiled with its own
``nvcc -c`` (all started together) and the objects are linked into one
shared library with a plain C interface, in ``build/kernels/`` at the
repository root, loaded with ``ctypes``.  The library's name carries a
hash of the sources, the headers they include (``*/csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt.  Nothing is
built or loaded at import: the first kernel launch builds, and a build
failure raises.

Each kernel module declares the C signatures it calls with
:func:`declare` when it is imported; :func:`lib` applies them all when it
loads the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
SOURCES = tuple(sorted(KERNELS_DIR.glob("*/csrc/*.cu")))
HEADERS = tuple(sorted(KERNELS_DIR.glob("*/csrc/*.cuh")))
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

MAX_SMEM = 232448                 # dynamic shared memory a block may use

_SIGNATURES: Dict[str, Tuple[List, object]] = {}
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def declare(name: str, argtypes: List, restype) -> None:
    """Record the C signature of ``name`` (applied when the library loads).

    Pointers and the stream must be ``ctypes.c_void_p``: an undeclared
    argument is passed as a 32-bit int and cuts the pointer."""
    _SIGNATURES[name] = (list(argtypes), restype)
    with _LIB_LOCK:
        if _LIB is not None:
            _apply(_LIB, name)


def _apply(loaded: ctypes.CDLL, name: str) -> None:
    argtypes, restype = _SIGNATURES[name]
    fn = getattr(loaded, name)
    fn.argtypes, fn.restype = argtypes, restype


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile each source to an object, one ``nvcc`` each, all started
    together, and link the objects into one shared library (if not built
    yet); return its path.  ``verbose`` prints ``-Xptxas -v``'s report."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{stem}.{src.parent.parent.name}.{src.stem}.o"
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


def lib() -> ctypes.CDLL:
    """The loaded library (built at first use) with every declared
    signature applied."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            loaded = ctypes.CDLL(str(build()))
            for name in _SIGNATURES:
                _apply(loaded, name)
            _LIB = loaded
    return _LIB


def on_cpu(x, meta: bool = False) -> bool:
    """True for a CPU tensor (the wrapper takes the plain version); False
    for a CUDA tensor (the wrapper launches its kernel); raises on any
    other device.  With ``meta``, a meta tensor is True too: a meta tensor
    holds a shape and no values, so the plain version there only derives
    the output's shape (the dry run's counts, ``launch/hlo_cost.py``).
    That is not a fallback: nothing runs, and a meta tensor can launch
    nothing.  Only the flash wrappers, which the dry run reaches, pass
    it."""
    if x.device.type == "cpu" or (meta and x.device.type == "meta"):
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def check_tensor(name: str, x, shape, dtype, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before it passes a
    pointer."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error (the launch was
    refused: too many threads, too much shared memory, ...)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
