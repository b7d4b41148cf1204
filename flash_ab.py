"""K6 on one NVIDIA card: the tree's kernel at its own plan and at other
split lengths, and optionally an earlier version of its source, in turns.

    python3 flash_ab.py [OLD.cu]

At chip_smoke.py's K6 timing shapes (decode B=8, NH=24, KH=8, hd=128, bf16
over a full cache of 512 and 4096 slots, a serving step of 8 slots at
positions 64–104 of 512, and the causal prefill B=1, H=24, S=2048) it
holds every variant against the plain version, then times the variants in
turns (in order, then in reverse).  The variants are the tree's kernel at
plan()'s choice and, at the split-path shapes, at every split length of
SPLIT_LENS below the cache length and at one split over the whole cache,
each through kernel.py's ``enqueue`` (the wrapper past its checks).  OLD.cu
is a flash.cu whose C entry takes no scratch, path or split length (the
source before the split and MMA paths, as at commit 34c5a4f), built on its
own with the port's nvcc flags into build/flash_ab/ and called the same
way: an output allocated, one C call.  Each variant gets, from both
turns, the profiler's device time and the CUDA-event time of back-to-back
calls (host gaps included).  The host's time to issue one call is taken
in HOST_ROUNDS rounds that visit every variant, and the full wrapper
(checks included), in turn, so that the shared host's drift reaches them
alike; each gets its quartiles.  Each shape's JSON line also has the plain
version's and SDPA's device times and the bound, from chip_smoke.py's
helpers.  Exits with 2 without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SPLIT_LENS = (32, 64, 128, 256, 512, 1024)
HOST_ROUNDS = 15


def host_ms(fn, iters: int) -> float:
    """The host's ms to issue one call: ``iters`` calls on the host's
    clock, the card idle at the start."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def old_caller(src):
    """(q, k, v, q_pos, kv_pos) → out through OLD.cu's C entry."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import kernel as FK
    out_dir = os.path.join(ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "old.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    src], check=True)
    fn = ctypes.CDLL(lib).flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 6 + [I] * 9 + [ctypes.c_float, P], I

    def call(q, k, v, qp, kp):
        b, sq, nh, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), out.data_ptr(), b, sq, k.shape[1], nh,
                 k.shape[2], hd, FK._DTYPES[q.dtype], 1, 0, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch("flash_attention_fwd (OLD.cu)", err)
        return out
    return call


def tree_caller(path, split_len):
    """The same through the tree's kernel with the plan (path, split_len)."""
    from repro_torch.kernels._build import lib
    from repro_torch.kernels.flash import kernel as FK

    def call(q, k, v, qp, kp):
        return FK.enqueue(lib().flash_attention_fwd, q, k, v, qp, kp, True,
                          None, q.shape[-1] ** -0.5, path, split_len)
    return call


def variants(q, k, old):
    """{name: caller} at the shape of q and k."""
    from repro_torch.kernels.flash import kernel as FK
    path, split_len = FK.plan_of(q, k)
    out = {} if old is None else {"old": old}
    out[f"plan {path} {split_len}"] = tree_caller(path, split_len)
    if path == "split":
        sk = k.shape[1]
        whole = -(-sk // FK.TILE_KEYS) * FK.TILE_KEYS
        for n in [n for n in SPLIT_LENS if n < sk] + [whole]:
            if n != split_len:
                out[f"split {n}"] = tree_caller("split", n)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,
                                               position_mask)
    dev = torch.device("cuda")
    old = old_caller(sys.argv[1]) if len(sys.argv) > 1 else None
    g = torch.Generator(device=dev).manual_seed(4)
    pre = [torch.randn((1, 24, 2048, 128), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2).contiguous() for _ in range(3)]
    pos = torch.arange(2048, dtype=torch.int32, device=dev)[None]
    shapes = {
        "decode B=8 Sk=512": CS.full_cache_inputs(dev, 8, 512, 24, 8, 128,
                                                  torch.bfloat16, 512),
        "decode B=8 Sk=4096": CS.full_cache_inputs(dev, 8, 4096, 24, 8, 128,
                                                   torch.bfloat16, 4096),
        "serving step B=8 Sk=512 positions 64-104":
            CS.serving_step_inputs(dev, 64),
        "causal prefill B=1 H=24 S=2048":
            tuple(pre) + (pos, pos)}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    for shape, (q, k, v, qp, kp) in shapes.items():
        iters = 10 if "prefill" in shape else 50
        ref = flash_attention_fwd_ref(q, k, v, qp, kp)
        tol = 2e-5 + 2.0 ** -7 * ref.float().abs()
        calls = variants(q, k, old)
        row = {"shape": shape, "variants": {}}
        for name, call in calls.items():
            err = (call(q, k, v, qp, kp).float() - ref.float()).abs()
            if not bool((err <= tol).all()):
                CS.fail(f"{name} at {shape}: err {float(err.max())} over "
                        f"the limit")
            row["variants"][name] = {"max_abs_err": float(err.max()),
                                     "ms": [], "ms_from": [], "call_ms": []}
        for name in list(calls) + list(reversed(calls)):
            fn = (lambda c=calls[name]: c(q, k, v, qp, kp))
            ms, src = CS.device_ms(fn, iters)
            entry = row["variants"][name]
            entry["ms"].append(ms)
            entry["ms_from"].append(src)
            entry["call_ms"].append(CS.cuda_time_ms(fn, iters))
        calls["wrapper"] = FK.flash_attention_fwd
        hosts = {name: [] for name in calls}
        for _ in range(HOST_ROUNDS):
            for name, call in calls.items():
                hosts[name].append(host_ms(
                    lambda c=call: c(q, k, v, qp, kp), iters))
        # [first quartile, median, third quartile] of each
        row["host_ms"] = {name: statistics.quantiles(t, n=4)
                          for name, t in hosts.items()}
        mask = position_mask(qp, kp, True, None)[:, None]
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if "prefill" in shape:          # as chip_smoke.py times it
            qs, ks, vs = (t.contiguous() for t in (qs, ks, vs))
        sdpa = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)) if "prefill" in shape else (
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))
        row["sdpa_ms"], row["sdpa_ms_from"] = CS.device_ms(sdpa, iters)
        row["plain_ms"], row["plain_ms_from"] = CS.device_ms(
            lambda: flash_attention_fwd_ref(q, k, v, qp, kp), iters)
        row["bound_ms"], row["bound_by"] = CS.flash_bound_ms(
            *CS.flash_cost(q, k, qp, kp))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
