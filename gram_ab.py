"""K3 and K4 on one NVIDIA card: the tree's kernels on each path, and
optionally an earlier version of their source, in turns.

    python3 gram_ab.py [OLD.cu]

At chip_smoke.py's gram timing shapes (R=2 θ rows, D=20, the bucket's 32
_FAR rows: the MAP fit's n=544, and n=2048) it holds every variant against
the plain versions, then times the variants in ROUNDS turns (in order,
then in reverse): each turn takes the profiler's device time and the
CUDA-event time of back-to-back calls (host gaps included) of every
variant.  The variants:

  K3  "same": x1 is x2, the fit's call (the tiles I ≤ J, each pair once);
      "copy": x2 a copy of x1 (every tile, the cross path);
      "column": the n1 = 1 column k(x_i, X) of the rank-one refit;
  K4  "same" and "copy";
and, with OLD.cu, "old" for each kernel: a gram.cu whose C entries take
no plan (the source before the symmetric path, as at commit 90e3ac7:
``git show 90e3ac7:src/repro_torch/kernels/matern/csrc/gram.cu >
build/gram_old.cu``), built on its own with the port's nvcc flags into
build/gram_ab/ and called the same way: outputs and scratch allocated,
one C call.  Each shape's JSON line also has the plain versions' device
times and the bounds, from chip_smoke.py's helpers.  Exits with 2 without
a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ROUNDS = 3


def old_callers(src):
    """(K3, K4) through OLD.cu's C entries."""
    import torch
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "gram_ab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "old.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", path,
                    src], check=True)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.matern52_gram_fwd.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.matern52_gram_bwd_theta.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.matern52_gram_bwd_scratch.argtypes = [I] * 4
    lib.matern52_gram_bwd_scratch.restype = ctypes.c_size_t
    for fn in (lib.matern52_gram_fwd, lib.matern52_gram_bwd_theta):
        fn.restype = I

    def fwd(x1, x2, ils, amp):
        r, d = ils.shape
        out = torch.empty((r, x1.shape[0], x2.shape[0]), dtype=torch.float64,
                          device=x1.device)
        err = lib.matern52_gram_fwd(
            x1.data_ptr(), x2.data_ptr(), ils.data_ptr(), amp.data_ptr(),
            out.data_ptr(), r, x1.shape[0], x2.shape[0], d,
            torch.cuda.current_stream().cuda_stream)
        _build.check_launch("matern52_gram_fwd (OLD.cu)", err)
        return out

    def bwd(x1, x2, ils, amp, g):
        r, d = ils.shape
        n1, n2 = x1.shape[0], x2.shape[0]
        f64, dev = torch.float64, x1.device
        part = torch.empty((lib.matern52_gram_bwd_scratch(r, n1, n2, d),),
                           dtype=f64, device=dev)
        d_inv = torch.empty((r, d), dtype=f64, device=dev)
        d_amp = torch.empty((r,), dtype=f64, device=dev)
        err = lib.matern52_gram_bwd_theta(
            x1.data_ptr(), x2.data_ptr(), ils.data_ptr(), amp.data_ptr(),
            g.data_ptr(), part.data_ptr(), d_inv.data_ptr(), d_amp.data_ptr(),
            r, n1, n2, d, torch.cuda.current_stream().cuda_stream)
        _build.check_launch("matern52_gram_bwd_theta (OLD.cu)", err)
        return d_inv, d_amp
    return fwd, bwd


def variants(x, xc, ils, amp, g, old):
    """{name: (kernel, call)} at one shape; every call returns what its
    wrapper returns."""
    from repro_torch.kernels.matern import kernel as K
    n = x.shape[0]
    col = n // 2
    xi = x[col:col + 1]
    out = {}
    if old is not None:
        out["K3 old"] = ("K3", lambda: old[0](x, x, ils, amp))
    out["K3 same"] = ("K3", lambda: K.matern52_gram_fwd(x, x, ils, amp))
    out["K3 copy"] = ("K3", lambda: K.matern52_gram_fwd(x, xc, ils, amp))
    out["K3 column"] = ("K3", lambda: K.matern52_gram_fwd(xi, x, ils, amp))
    if old is not None:
        out["K4 old"] = ("K4", lambda: old[1](x, x, ils, amp, g))
    out["K4 same"] = ("K4", lambda: K.matern52_gram_bwd_theta(x, x, ils, amp,
                                                              g))
    out["K4 copy"] = ("K4", lambda: K.matern52_gram_bwd_theta(x, xc, ils,
                                                              amp, g))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gram_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                                matern52_gram_ref)
    dev = torch.device("cuda")
    old = old_callers(sys.argv[1]) if len(sys.argv) > 1 else None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    for n, iters in ((544, 200), (2048, 20)):
        x, _, ils, amp, g = CS.gram_inputs(n, n, 20, 2, dev, far=32)
        xc = x.clone()
        calls = variants(x, xc, ils, amp, g, old)
        k_ref = matern52_gram_ref(x, x, ils, amp)
        k_tol, il_tol, amp_tol = CS.gram_tolerances(x, x, ils, amp, g)
        di_r, da_r = matern52_gram_bwd_theta_ref(x, x, ils, amp, g)
        real = torch.ones((n, n), dtype=torch.bool, device=dev)
        real[-32:, -32:] = False
        row = {"shape": f"R=2 n={n} D=20 far=32", "variants": {}}
        for name, (kern, call) in calls.items():
            got = call()
            if kern == "K3":
                ref = k_ref[:, n // 2:n // 2 + 1] if "column" in name else k_ref
                tol = (k_tol[:, n // 2:n // 2 + 1] if "column" in name
                       else k_tol)
                keep = real[n // 2:n // 2 + 1] if "column" in name else real
                e = (got - ref).abs()
                ok = bool((e <= tol)[:, keep].all())
                err = float(e[:, keep].max())
            else:
                e_i, e_a = (got[0] - di_r).abs(), (got[1] - da_r).abs()
                ok = bool((e_i <= il_tol).all() and (e_a <= amp_tol).all())
                err = max(float(e_i.max()), float(e_a.max()))
            if not ok:
                CS.fail(f"{name} at n={n}: err {err} over the limit")
            row["variants"][name] = {"max_abs_err": err, "ms": [],
                                     "ms_from": [], "call_ms": []}
        names = list(calls)
        for turn in range(ROUNDS):
            for name in names if turn % 2 == 0 else reversed(names):
                fn = calls[name][1]
                ms, src = CS.device_ms(fn, iters)
                entry = row["variants"][name]
                entry["ms"].append(ms)
                entry["ms_from"].append(src)
                entry["call_ms"].append(CS.cuda_time_ms(fn, iters))
        for entry in row["variants"].values():
            entry["median_ms"] = statistics.median(entry["ms"])
            entry["median_call_ms"] = statistics.median(entry["call_ms"])
        row["plain_ms"] = {
            "K3": CS.device_ms(lambda: matern52_gram_ref(x, x, ils, amp),
                               iters)[0],
            "K4": CS.device_ms(lambda: matern52_gram_bwd_theta_ref(
                x, x, ils, amp, g), iters)[0]}
        row["bound_ms"] = {
            "K3": CS.bound_ms(*CS.gram_cost(2, n, n, 20, False)),
            "K4": CS.bound_ms(*CS.gram_cost(2, n, n, 20, True))}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
