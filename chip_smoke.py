"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. build    compile the CUDA kernels from src/repro_torch/.../csrc
  2. kernels  hold K1 (matern52_posterior_fwd) and K2
              (matern52_posterior_bwd_xq) against their plain PyTorch
              versions on the card, and check batch-width independence
  3. main     the paper's D-BE suggest path through GPSampler at D=20,
              B=10 restarts, n≈512 observations: launches == rounds, C3
              (D-BE reproduces SEQ per restart) bitwise, and the port on
              the card against the port on the CPU on a small problem;
              then K1/K2 against their plain versions on that run's last
              state, at every batch bucket the evaluator pads to
  4. breakdown  device time of one more ask by kind (torch.profiler)
  5. timing   CUDA-event times of K1/K2 and their plain versions beside
              the least time the card could take (bound)
Then it prints the card, a "kernels" JSON line, and the result line.
Exits with 2, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; f64 67 TFLOP/s on
# the tensor cores (matrix products) and 34 TFLOP/s on the CUDA cores (the
# elementwise rest)
HBM_BYTES_PER_S = 3.35e12
F64_MMA_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
EPS64 = 2.220446049250313e-16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- helpers
def make_state(n: int, d: int, seed: int, device, n_pad: int = 5):
    """GP state at a fixed θ on a BBOB objective: n−n_pad real points in
    the unit cube, padded to n with _FAR pseudo-points (the fit's layout),
    with K⁻¹ materialized."""
    import numpy as np
    import torch
    from repro_torch.bo.objectives import make_objective
    from repro_torch.gp.fit import standardize
    from repro_torch.gp.gpr import fit_gram, pad_gp, with_kinv
    from repro_torch.gp.kernels import KernelParams

    rng = np.random.default_rng(seed)
    m = n - n_pad
    U = rng.uniform(0.0, 1.0, (m, d))
    obj = make_objective("rastrigin", d)
    y = np.array([obj(-5.0 + 10.0 * u) for u in U])
    y_std, _, _ = standardize(torch.as_tensor(-y).to(device))
    params = KernelParams(
        log_lengthscale=torch.full((d,), math.log(0.25 * math.sqrt(d)),
                                   dtype=torch.float64, device=device),
        log_amplitude=torch.tensor(0.3, dtype=torch.float64, device=device),
        log_noise=torch.tensor(-4.0, dtype=torch.float64, device=device))
    gp = with_kinv(fit_gram(torch.as_tensor(U).to(device), y_std, params))
    return pad_gp(gp, n) if n_pad else gp


def kernel_args(gp):
    import torch
    return (gp.x_train, gp.alpha, gp.kinv,
            torch.exp(-gp.params.log_lengthscale), gp.params.amplitude)


def sum_scales(xq, gp, t):
    """Magnitudes Σ|terms| of each sum the kernels take, so that an error
    is judged relative to the sum's own condition (cancellation)."""
    import torch
    from repro_torch.kernels.matern.ref import SQRT5, _scaled_sq_dists
    xt, alpha, kinv, ils, amp = kernel_args(gp)
    a, b, d2 = _scaled_sq_dists(xq, xt, ils)
    r = torch.sqrt(d2 + 1e-36)
    k = amp * (1.0 + SQRT5 * r + (5.0 / 3.0) * d2) * torch.exp(-SQRT5 * r)
    mean_scale = (k.abs() @ alpha.abs()).max()
    t_scale = (k.abs() @ kinv.abs()).max()
    c = (5.0 / 3.0) * amp * (1.0 + SQRT5 * r) * torch.exp(-SQRT5 * r)
    w = alpha.abs()[None, :] + 2.0 * t.abs()
    grad_scale = (ils * ((c * w).sum(-1, keepdim=True) * a.abs()
                         + (c * w) @ b.abs())).max()
    return float(mean_scale), float(t_scale), float(grad_scale)


def cuda_time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total", 0.0) or
                 getattr(ev, "self_cuda_time_total", 0.0) or 0.0)


def device_time_ms(fn, iters: int) -> float:
    """Device time per call: the sum of every kernel and copy the call
    runs on the card, from a torch.profiler trace of ``iters`` calls.
    Unlike an event pair around back-to-back calls, it leaves out the gaps
    while the card waits for the host to launch the next call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_device_us(ev) for ev in prof.key_averages())
    check(total_us > 0, "profiler recorded no device time")
    return total_us / 1e3 / iters


def fwd_cost(q, n, d):
    """(bytes, f64 matrix-product operations, other f64 operations) K1
    needs: each input read once, each output written once; the products
    a·bᵀ of the cross-gram and t = k*K⁻¹, then the elementwise Matérn and
    both epilogues."""
    nbytes = 8 * (q * d + n * d + n + n * n + d + 1 + 2 * q + q * n)
    return nbytes, 2 * q * n * n + 2 * q * n * d, 20 * q * n


def bwd_cost(q, n, d):
    """The same for K2: the product c·b, then the elementwise weights and
    the row sums."""
    nbytes = 8 * (q * d + n * d + n + q * n + q + d + 1 + 2 * q + q * d)
    return nbytes, 2 * q * n * d, 2 * q * n * d + 20 * q * n


def bound_ms(nbytes, mma_ops, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mma_ops / F64_MMA_FLOP_PER_S + ops / F64_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels.matern import kernel as K
    t0 = time.perf_counter()
    path = K.build(verbose=True)
    K._lib()
    log(f"[build] {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


def check_against_plain(gp, q, rng, err, tag):
    """K1 and K2 against their plain versions on the same CUDA tensors, at
    q queries (the first on a training point); errors go into ``err``."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_posterior_bwd_ref,
                                                matern52_posterior_fwd_ref)
    n, d = gp.x_train.shape
    dev = gp.x_train.device
    args = kernel_args(gp)
    amp = float(gp.params.amplitude)
    var_tol = 8 * n * EPS64 * amp * amp * float(gp.kinv.abs().max())
    xq = torch.as_tensor(rng.uniform(0, 1, (q, d))).to(dev)
    xq[0] = gp.x_train[0]                        # a query on a train point
    m_k, v_k, t_k = K.matern52_posterior_fwd(xq, *args)
    m_r, v_r, t_r = matern52_posterior_fwd_ref(xq, *args)
    gm = torch.as_tensor(rng.standard_normal(q)).to(dev)
    gv = torch.as_tensor(rng.standard_normal(q)).to(dev)
    xt, alpha, _, ils, ampt = args
    g_k = K.matern52_posterior_bwd_xq(xq, xt, alpha, t_k, v_k, ils, ampt,
                                      gm, gv)
    g_r = matern52_posterior_bwd_ref(xq, xt, alpha, t_r, v_r, ils, ampt,
                                     gm, gv)
    torch.cuda.synchronize()
    ms, ts, gs = sum_scales(xq, gp, t_r)
    e_m = float((m_k - m_r).abs().max())
    e_t = float((t_k - t_r).abs().max())
    e_v = float((v_k - v_r).abs().max())
    e_g = float((g_k - g_r).abs().max())
    err["fwd"] = max(err["fwd"], e_m, e_t, e_v)
    err["bwd"] = max(err["bwd"], e_g)
    check(bool(torch.isfinite(g_k).all()), f"{tag}: grad nan")
    check(e_m <= 1e-11 * ms, f"{tag}: mean err {e_m} > 1e-11·{ms}")
    check(e_t <= 1e-11 * ts, f"{tag}: t err {e_t} > 1e-11·{ts}")
    check(e_v <= var_tol, f"{tag}: var err {e_v} > {var_tol}")
    check(e_g <= 1e-11 * gs, f"{tag}: grad err {e_g} > 1e-11·{gs}")
    log(f"[kernels] {tag}: |Δmean| {e_m:.3e} (≤1e-11·{ms:.3e})"
        f"  |Δt| {e_t:.3e}  |Δvar| {e_v:.3e} (≤{var_tol:.3e})"
        f"  |Δgrad| {e_g:.3e} (≤1e-11·{gs:.3e})")


def check_batch_width(gp, rng, tag):
    """Row 0 alone vs in a batch of 10 that ends with repeated padding rows
    (as the evaluator pads): bitwise the same outputs."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    d = gp.x_train.shape[1]
    args = kernel_args(gp)
    xq = torch.as_tensor(rng.uniform(0, 1, (7, d))).to(gp.x_train.device)
    xb = torch.cat([xq, xq[-1:].expand(3, d)], 0).contiguous()
    outs = []
    for x in (xq[:1].contiguous(), xb):
        m, v, t = K.matern52_posterior_fwd(x, *args)
        ones = torch.ones_like(m)
        g = K.matern52_posterior_bwd_xq(x, args[0], args[1], t, v, args[3],
                                        args[4], ones, -0.5 * ones)
        outs.append((m, v, t, g))
    for a, b in zip(outs[0], outs[1]):
        check(torch.equal(a[0], b[0]), f"{tag}: row 0 differs with batch "
              f"width")
    for b in outs[1]:
        check(torch.equal(b[6], b[9]), f"{tag}: repeated row differs")


def phase_kernels(dev):
    import numpy as np
    err = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(7)
    for n in (32, 512, 2048):
        for d in (5, 20, 40):
            gp = make_state(n, d, seed=n + d, device=dev)
            for q in (1, 10, 1000):
                check_against_plain(gp, q, rng, err, f"n={n} D={d} q={q}")
            check_batch_width(gp, rng, f"n={n} D={d}")
    log(f"[kernels] batch-width independence: bitwise  max abs err "
        f"fwd {err['fwd']:.3e} bwd {err['bwd']:.3e}")
    return err


def phase_main_shapes(state, buckets, err):
    """K1/K2 against their plain versions on the state the main path's
    last ask evaluated, at every batch bucket its evaluator pads to."""
    import numpy as np
    gp = state[0]
    n, d = gp.x_train.shape
    rng = np.random.default_rng(17)
    for q in buckets:
        check_against_plain(gp, q, rng, err, f"main state n={n} D={d} q={q}")
    check_batch_width(gp, rng, f"main state n={n} D={d}")
    log(f"[kernels] main-path shapes (buckets {list(buckets)}): within "
        f"tolerance, batch width bitwise")


def phase_main(dev):
    import numpy as np
    import torch
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import GPSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.core.mso import maximize_acqf
    from repro_torch.kernels.matern import kernel as K

    D, B, N0 = 20, 10, 512
    obj = make_objective("rastrigin", D)
    space = BoxSpace.cube(D, -5.0, 5.0)
    s = GPSampler(space, strategy="dbe", n_restarts=B, n_startup_trials=N0,
                  posterior_backend="auto", seed=0)
    check(s.device.type == "cuda" and s.posterior_backend == "fused",
          f"sampler on {s.device} / {s.posterior_backend}")
    for _ in range(N0):
        t = s.ask()
        s.tell(t.trial_id, obj(t.x))

    K.reset_launch_counts()
    rounds0 = s.engine.stats.n_rounds
    per_ask = []
    for i in range(3):
        fit0, mso0 = s.stats.fit_time, s.stats.acqf_time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = s.ask()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s.tell(t.trial_id, obj(t.x))
        check(bool(np.all(np.isfinite(t.x))) and t.x.shape == (D,)
              and bool(np.all((t.x >= -5) & (t.x <= 5))),
              f"ask {i}: bad suggestion {t.x}")
        gp = s.last_acq_state[0]
        per_ask.append(dict(
            n=int(gp.x_train.shape[0]), ask_ms=wall * 1e3,
            fit_ms=(s.stats.fit_time - fit0) * 1e3,
            mso_ms=(s.stats.acqf_time - mso0) * 1e3,
            rounds=s.last_mso.n_rounds,
            median_iters=float(np.median(s.last_mso.n_iters))))
        log(f"[main] ask {i}: " + json.dumps(per_ask[-1]))
    launches = K.launch_counts()
    rounds = s.engine.stats.n_rounds - rounds0
    log(f"[main] rounds {rounds}  launches {json.dumps(launches)}")
    check(launches["matern52_posterior_fwd"] == rounds > 0,
          "forward launches != MSO rounds")
    check(launches["matern52_posterior_bwd_xq"] == rounds,
          "backward launches != MSO rounds")

    # C3 on one fitted state: D-BE reproduces SEQ per restart, bitwise
    state = s.last_acq_state
    rng = np.random.default_rng(3)
    x0 = np.concatenate([s.space.to_unit(s.best().x)[None],
                         rng.uniform(0, 1, (B - 1, D))], 0)
    res = {st: maximize_acqf(s._acq_fn, x0, 0.0, 1.0, acq_state=state,
                             strategy=st, options=s.mso_options)
           for st in ("seq", "dbe", "cbe")}
    seq, dbe = res["seq"], res["dbe"]
    check(np.array_equal(seq.n_iters, dbe.n_iters), "C3: n_iters differ")
    check(np.array_equal(seq.n_evals, dbe.n_evals), "C3: n_evals differ")
    check(np.array_equal(seq.x, dbe.x),
          f"C3: x differs by {np.abs(seq.x - dbe.x).max()}")
    c3 = dict(seq_rounds=seq.n_rounds, dbe_rounds=dbe.n_rounds,
              median_iters_seq=float(np.median(seq.n_iters)),
              median_iters_dbe=float(np.median(dbe.n_iters)),
              median_iters_cbe=float(np.median(res["cbe"].n_iters)),
              seq_ms=seq.wall_time * 1e3, dbe_ms=dbe.wall_time * 1e3,
              cbe_ms=res["cbe"].wall_time * 1e3)
    log("[main] C3 bitwise (n_iters, n_evals, x): " + json.dumps(c3))

    # small-input reference: the port on the card vs the port on the CPU
    d_small = 3
    objs = make_objective("rosenbrock", d_small)
    xs = {}
    for dv, backend in ((None, "auto"), ("cpu", "cholesky")):
        sm = GPSampler(BoxSpace.cube(d_small, -5.0, 5.0), strategy="dbe",
                       n_startup_trials=8, seed=0, device=dv,
                       posterior_backend=backend)
        out = []
        for _ in range(10):
            t = sm.ask()
            sm.tell(t.trial_id, objs(t.x))
            out.append(t.x)
        xs[backend] = np.array(out)
    diff = float(np.abs(xs["auto"] - xs["cholesky"]).max() / 10.0)
    log(f"[main] card (fused) vs CPU (cholesky), D=3, 2 BO trials: "
        f"max |Δx| in unit space {diff:.3e}")
    check(diff <= 1e-6, f"card vs CPU suggestions differ by {diff}")
    return s, obj, launches, per_ask, c3, state


def timed_ask(s, obj):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = s.ask()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    s.tell(t.trial_id, obj(t.x))
    return wall_ms


def phase_breakdown(s, obj):
    """Where one more ask's time goes on the card, from a torch.profiler
    trace of the card alone (no host-op events): device time of K1, K2,
    host↔device copies and all other kernels (the fit's Cholesky/solves,
    LogEI's elementwise ops), against the ask's wall time.  The tracer
    adds host time, so the idle share of the traced ask is an upper bound;
    the ask just before it, untraced, gives the estimate
    1 − busy / untraced wall (two asks of one run, same n bucket)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    untraced_ms = timed_ask(s, obj)
    fit0, mso0 = s.stats.fit_time, s.stats.acqf_time
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the clock runs inside the trace: its start-up and the event
        # processing at its end are not part of the ask
        t0 = time.perf_counter()
        t = s.ask()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    s.tell(t.trial_id, obj(t.x))
    dev_us = {"k1": 0.0, "k2": 0.0, "memcpy": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = _device_us(ev)
        if us <= 0:
            continue
        name = ev.key
        if "posterior_fwd_kernel" in name:
            dev_us["k1"] += us
        elif "posterior_bwd_xq_kernel" in name:
            dev_us["k2"] += us
        elif "Memcpy" in name or "memcpy" in name:
            dev_us["memcpy"] += us
        else:
            dev_us["other"] += us
    busy_ms = sum(dev_us.values()) / 1e3
    row = dict(n=int(s.last_acq_state[0].x_train.shape[0]),
               untraced_ask_ms=untraced_ms, wall_ms=wall_ms,
               fit_host_ms=(s.stats.fit_time - fit0) * 1e3,
               mso_host_ms=(s.stats.acqf_time - mso0) * 1e3,
               rounds=s.last_mso.n_rounds,
               device_ms={k: v / 1e3 for k, v in dev_us.items()},
               device_busy_ms=busy_ms)
    if busy_ms > 0:
        row["device_idle_share_traced"] = 1.0 - busy_ms / wall_ms
        row["device_idle_share_est"] = max(0.0, 1.0 - busy_ms / untraced_ms)
    else:
        row["device_ms"] = "not measured (profiler saw no device time)"
    log("[breakdown] " + json.dumps(row))
    return row


def phase_timing(dev, state):
    import torch
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_posterior_bwd_ref,
                                                matern52_posterior_fwd_ref)
    gp = state[0]
    rows = []
    shapes = [(gp, 1), (gp, 10),
              (make_state(2048, 20, seed=11, device=dev), 1000)]
    g = torch.Generator(device="cpu").manual_seed(5)
    for gps, q in shapes:
        n, d = gps.x_train.shape
        args = kernel_args(gps)
        xt, alpha, _, ils, amp = args
        xq = torch.rand((q, d), generator=g, dtype=torch.float64).to(dev)
        gm = torch.ones(q, dtype=torch.float64, device=dev)
        gv = -0.5 * gm
        _, v, t = K.matern52_posterior_fwd(xq, *args)
        iters = 20 if q >= 1000 else 200
        calls = {
            "fwd": lambda: K.matern52_posterior_fwd(xq, *args),
            "fwd_plain": lambda: matern52_posterior_fwd_ref(xq, *args),
            "bwd": lambda: K.matern52_posterior_bwd_xq(
                xq, xt, alpha, t, v, ils, amp, gm, gv),
            "bwd_plain": lambda: matern52_posterior_bwd_ref(
                xq, xt, alpha, t, v, ils, amp, gm, gv)}
        row = dict(n=int(n), D=int(d), q=q)
        for key, fn in calls.items():
            # device time per call, and event time per call (which also
            # counts the card waiting on the host between calls)
            row[f"{key}_ms"] = device_time_ms(fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        fb, fby = bound_ms(*fwd_cost(q, n, d))
        bb, bby = bound_ms(*bwd_cost(q, n, d))
        row.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
                   bwd_bound_by=bby)
        rows.append(row)
        log("[timing] " + json.dumps(row))
    return rows


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (turns TF32 off)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase_build()
    err = phase_kernels(dev)
    sampler, obj, launches, per_ask, c3, state = phase_main(dev)
    from repro_torch.engine.plan import EvalPlan
    plan = EvalPlan.for_batch(sampler.B, sampler.space.dim,
                              bucketed=sampler.mso_options.bucketed)
    phase_main_shapes(state, plan.buckets, err)
    phase_breakdown(sampler, obj)
    timing = phase_timing(dev, state)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    main_row = timing[1]                # the main path's shape, q = B = 10
    kernels = []
    for name, key, src, replaces in (
            ("matern52_posterior_fwd", "fwd",
             "src/repro_torch/kernels/matern/csrc/posterior.cu",
             "src/repro/kernels/matern/kernel.py:132"),
            ("matern52_posterior_bwd_xq", "bwd",
             "src/repro_torch/kernels/matern/csrc/posterior.cu",
             "src/repro/kernels/matern/ops.py:50")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[key], "ms": main_row[f"{key}_ms"],
            "plain_ms": main_row[f"{key}_plain_ms"],
            "bound_ms": main_row[f"{key}_bound_ms"],
            "bound_by": main_row[f"{key}_bound_by"], "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
