"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. build    compile the CUDA kernels from src/repro_torch/.../csrc (one
              nvcc for each source, all started together) and link them
              into one library
  2. kernels  hold K1 (matern52_posterior_fwd) and K2
              (matern52_posterior_bwd_xq) against their plain PyTorch
              versions on the card, and check batch-width independence;
              then K3 (matern52_gram_fwd) and K4 (matern52_gram_bwd_theta)
              at n ∈ {32, 544, 2048}, D ∈ {5, 20, 40}, R ∈ {1, 2}, the
              n1 = 1 cross column and _FAR rows
  3. main     slice 1, the paper's D-BE suggest path through GPSampler at
              D=20, B=10 restarts, n≈512 observations: K1 = K2 = rounds,
              K3 − K4 = asks, C3 (D-BE reproduces SEQ per restart)
              bitwise, and the port on the card against the port on the
              CPU on a small problem; then K1/K2 against their plain
              versions on that run's last state, at every batch bucket
  4. ask      slice 2, the fused dbe_vec ask (AskEngine) at the same width:
              full, bucket-growth, incremental and fallback asks with
              exact K1–K4 launch counts, the incremental state against a
              from-scratch fit, fused == host bitwise on a small problem,
              and per-ask fit / MSO / wall ms by kind (obs tracer on);
              K3/K4 against their plain versions on that run's own state
              (fitted θ, padded x, the fit's upstream gradient)
  5. breakdown  kernel launches and device time of one MAP-fit
              evaluation with K3/K4 and with the plain gram; device time of
              one more host-path ask, and of one fused full and one fused
              incremental ask, by kernel (torch.profiler), with the idle
              share
  6. timing   CUDA-event times of K1–K4 and their plain versions beside
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


def gram_cost(r, n1, n2, d, backward):
    """(bytes, matrix-product f64 ops, other f64 ops) K3 or K4 needs:
    inputs read once, outputs written once. K3: the products a·bᵀ of the
    expanded d² (2·E·D for E = R·n1·n2 entries), per entry the elementwise
    Matérn (14 operations, sqrt and exp one each), the rows' squared
    norms. K4: the same d², Ḡ's weight c_ij (17 a entry with the Matérn),
    and Σ_ij c_ij (x1_id − x2_jd)², which is Σ_i x1_id² rowsum_i(C) +
    Σ_j x2_jd² colsum_j(C) − 2 Σ_i x1_id (C·x2)_id: one more product C·x2
    (2·E·D) and O(R·(n1 + n2)·D) operations besides."""
    ins = n1 * d + n2 * d + r * d + r
    entries = r * n1 * n2
    rows = r * (n1 + n2) * d
    if backward:
        nbytes = 8 * (ins + entries + r * d + r)
        return nbytes, 4 * entries * d, 17 * entries + 6 * rows
    return 8 * (ins + entries), 2 * entries * d, 14 * entries + 2 * rows


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
    # each fit: one K3 and one K4 per evaluation, one K3 for the final gram
    check(launches["matern52_gram_bwd_theta"] > 0
          and launches["matern52_gram_fwd"]
          - launches["matern52_gram_bwd_theta"] == 3,
          "gram launches: K3 − K4 != asks")

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


# ------------------------------------------------- gram kernels K3 / K4
def gram_inputs(n1, n2, d, r, device, far=0, seed=0):
    """x1 (n1, D), x2 (n2, D) in the unit cube (x1 = x2 when n1 = n2), the
    last ``far`` rows of x2 replaced by _FAR pseudo-points, 1/ℓ in
    [e⁻¹, e⁴] (R, D), σ_f² (R,) and an upstream Ḡ (R, n1, n2) that, as in
    the masked LML, is 0 on entries of _FAR rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 31 * n1 + d)
    x2 = rng.uniform(0, 1, (n2, d))
    if far:
        x2[-far:] = 1e6 + np.arange(far)[:, None]
    x1 = x2 if n1 == n2 else rng.uniform(0, 1, (n1, d))
    ils = np.exp(rng.uniform(-1.0, 4.0, (r, d)))
    amp = np.exp(rng.uniform(-1.0, 1.0, r))
    g = rng.standard_normal((r, n1, n2))
    if far:
        g[:, :, -far:] = 0.0
        if n1 == n2:
            g[:, -far:, :] = 0.0
    return tuple(torch.tensor(v, device=device) for v in (x1, x2, ils, amp, g))


def gram_tolerances(x1, x2, ils, amp, g):
    """Stated tolerances of K3/K4 against their plain versions: K3 per
    entry 4·D·eps·σ_f²·(1 + |a_i|² + |b_j|²) (the expanded d² cancels to
    eps·(|a|² + |b|²) in any summation order); K4 1e-10 of Σ|terms| of
    each of its sums."""
    import torch
    from repro_torch.kernels.matern.ref import SQRT5, _scaled_sq_dists
    a, b, d2 = _scaled_sq_dists(x1, x2, ils)
    d = x1.shape[1]
    k_tol = 4 * d * EPS64 * amp[:, None, None] * (
        1 + (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :])
    r = torch.sqrt(d2 + 1e-36)
    e = torch.exp(-SQRT5 * r)
    c = g.abs() * (1 + SQRT5 * r) * e
    s_il = torch.stack([(c * (x1[:, k, None] - x2[None, :, k]) ** 2
                         ).sum((-1, -2)) for k in range(d)], -1)
    s_il = (5 / 3) * amp[:, None] * ils * s_il
    s_amp = (g.abs() * (1 + SQRT5 * r + 5 / 3 * d2) * e).sum((-1, -2))
    return k_tol, 1e-10 * s_il, 1e-10 * s_amp


def check_gram(tag, inputs, far, err):
    """K3 and K4 against their plain versions on ``inputs`` (x1, x2, 1/ℓ,
    σ_f², Ḡ), whose last ``far`` rows of x2 (and of x1 when n1 = n2) are
    _FAR rows; errors go into ``err``."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                                matern52_gram_ref)
    x1, x2, ils, amp, g = inputs
    (r, _), n1, n2 = ils.shape, x1.shape[0], x2.shape[0]
    dev = x1.device
    k_k = K.matern52_gram_fwd(x1, x2, ils, amp)
    k_r = matern52_gram_ref(x1, x2, ils, amp)
    di_k, da_k = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    di_r, da_r = matern52_gram_bwd_theta_ref(x1, x2, ils, amp, g)
    di_2, da_2 = K.matern52_gram_bwd_theta(x1, x2, ils, amp, g)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k_k).all()), f"{tag}: K3 not finite")
    check(bool(torch.isfinite(di_k).all() and torch.isfinite(da_k).all()),
          f"{tag}: K4 not finite")
    k_tol, il_tol, amp_tol = gram_tolerances(x1, x2, ils, amp, g)
    # entries between two _FAR rows are cancellation noise in any expanded
    # d² (finite, checked above); the masked LML multiplies them by 0
    real = torch.ones((n1, n2), dtype=torch.bool, device=dev)
    if far and n1 == n2:
        real[-far:, -far:] = False
    e_k = ((k_k - k_r).abs())[:, real]
    check(bool((e_k <= k_tol[:, real]).all()),
          f"{tag}: K3 err {float(e_k.max())} over tolerance")
    e_i, e_a = (di_k - di_r).abs(), (da_k - da_r).abs()
    check(bool((e_i <= il_tol).all()), f"{tag}: K4 d(1/ℓ) err "
          f"{float(e_i.max())} over 1e-10·Σ|terms|")
    check(bool((e_a <= amp_tol).all()), f"{tag}: K4 dσ² err "
          f"{float(e_a.max())} over 1e-10·Σ|terms|")
    check(torch.equal(di_k, di_2) and torch.equal(da_k, da_2),
          f"{tag}: K4 not bitwise run to run")
    if n1 == n2:
        check(torch.equal(torch.diagonal(k_k, dim1=-2, dim2=-1),
                          amp[:, None].expand(r, n1)),
              f"{tag}: K3 diagonal is not σ_f² exactly")
    err["gram_fwd"] = max(err["gram_fwd"], float(e_k.max()))
    err["gram_bwd"] = max(err["gram_bwd"], float(e_i.max()),
                          float(e_a.max()))
    # K3's largest tolerance between two points in the cube (_FAR rows
    # have tolerances as large as their |x|²)
    m1 = n1 - far if n1 == n2 else n1
    return (float(e_k.max()), float(k_tol[:, :m1, :n2 - far].max()),
            float(e_i.max()), float(il_tol.max()))


def phase_gram_kernels(dev, err):
    err.update(gram_fwd=0.0, gram_bwd=0.0)
    for n in (32, 544, 2048):
        far = 32 if n >= 544 else 0
        for d in (5, 20, 40):
            for r in (1, 2):
                check_gram(f"gram n={n} D={d} R={r} far={far}",
                           gram_inputs(n, n, d, r, dev, far), far, err)
        # the incremental refit's cross column k(x_new, X): n1 = 1, R = 1
        e = check_gram(f"gram n1=1 n2={n} D=20 far={far}",
                       gram_inputs(1, n, 20, 1, dev, far), far, err)
        log(f"[kernels] gram n={n}: D ∈ (5, 20, 40), R ∈ (1, 2) and the "
            f"n1=1 column within tolerance (column: K3 |Δ| {e[0]:.3e}, "
            f"K4 |Δ| {e[2]:.3e})")
    log(f"[kernels] gram max abs err fwd {err['gram_fwd']:.3e} bwd "
        f"{err['gram_bwd']:.3e}; K4 bitwise run to run; K3 diagonal exact")


def phase_ask_shapes(s, err):
    """K3/K4 against their plain versions on the ask phase's own state: its
    padded x (bucket 544, _FAR rows past n) at the R=2 θ rows its next full
    refit starts from (the fitted θ and one jittered row), with the fit's
    own upstream Ḡ (captured from autograd through the plain gram of the
    masked MAP objective); then the incremental refit's cross column
    k(x_n, X) at the fitted θ, with Ḡ's row of that point."""
    import torch
    from repro_torch.gp import kernels as gk
    from repro_torch.gp.fit import (_neg_map_objective, standardize_masked,
                                    theta_init_grid, unpack_theta)
    from repro_torch.kernels.matern.ref import matern52_gram_ref
    ask = s._ask
    x, n, D = ask._x, ask.n_obs, ask.cfg.dim
    b = x.shape[0]
    valid = torch.arange(b, device=x.device) < n
    y_std, _, _ = standardize_masked(-ask._y, valid)
    thetas = theta_init_grid(D, torch.float64, ask.cfg.gp_fit_restarts,
                             seed=n, init=unpack_theta(ask._theta, D),
                             device=x.device)
    upstream = []

    def plain_capturing(x1, x2, params):
        k = gk.matern52_plain(x1, x2, params)
        k.register_hook(upstream.append)
        return k

    on_path = gk.KERNELS["matern52"]
    gk.KERNELS["matern52"] = plain_capturing
    tb = thetas.clone().requires_grad_(True)
    f = _neg_map_objective(tb, x, y_std, valid, D, "matern52")
    torch.autograd.grad(f.sum(), tb)
    gk.KERNELS["matern52"] = on_path
    g = upstream[0].contiguous()
    p = unpack_theta(thetas, D)
    ils = torch.exp(-p.log_lengthscale).contiguous()
    amp = p.amplitude.contiguous()
    r, far = thetas.shape[0], b - n
    e = check_gram(f"ask state gram R={r} n={b} ({far} _FAR) D={D}",
                   (x, x, ils, amp, g), far, err)
    c = check_gram(f"ask state column n1=1 n2={b} D={D}",
                   (x[n - 1:n].contiguous(), x, ils[:1].contiguous(),
                    amp[:1].contiguous(), g[:1, n - 1:n].contiguous()),
                   far, err)
    lo = float(matern52_gram_ref(x[:n], x[:n], ils, amp).min())
    log(f"[kernels] ask state (n={n}, bucket {b}, fitted θ): gram R={r} K3 "
        f"|Δ| {e[0]:.3e} (tolerance between real points ≤ {e[1]:.3e}), "
        f"K4 |Δ| {e[2]:.3e}; "
        f"column K3 |Δ| {c[0]:.3e}, K4 |Δ| {c[2]:.3e}; K3 entries between "
        f"real points from {lo:.3e} to {float(amp.max()):.3e}")


def phase_fit_census(dev):
    """One MAP-fit evaluation (value and gradient of the batched objective
    over R=2 θ rows at n=544, D=20, 32 _FAR rows) traced on the card:
    kernel launches and device ms per evaluation with the gram kernels
    K3/K4 (the path), then with the plain gram differentiated by autograd
    (the plain version, for comparison only), and the two results held
    against each other."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.gp import kernels as gk
    from repro_torch.gp.fit import _neg_map_objective, theta_init_grid

    n, far, D, iters = 544, 32, 20, 5
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.uniform(0, 1, (n - far, D)),
                        1e6 + np.arange(far)[:, None] + np.zeros((far, D))])
    y = np.concatenate([rng.standard_normal(n - far), np.zeros(far)])
    x, y = (torch.tensor(v, device=dev) for v in (x, y))
    valid = torch.arange(n, device=dev) < n - far
    theta = theta_init_grid(D, torch.float64, 2, seed=1, device=dev)

    def evaluate():
        tb = theta.clone().requires_grad_(True)
        f = _neg_map_objective(tb, x, y, valid, D, "matern52")
        (g,) = torch.autograd.grad(f.sum(), tb)
        return f.detach(), g

    on_path = gk.KERNELS["matern52"]
    rows, results = {}, {}
    try:
        for mode in ("kernels", "plain"):
            gk.KERNELS["matern52"] = (on_path if mode == "kernels"
                                      else gk.matern52_plain)
            results[mode] = evaluate()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    evaluate()
                torch.cuda.synchronize()
            kernels = [ev for ev in prof.key_averages()
                       if _device_us(ev) > 0 and "mem" not in ev.key.lower()]
            dev_us = device_breakdown(prof)
            rows[mode] = dict(
                kernel_launches_per_eval=sum(ev.count for ev in kernels)
                / iters,
                device_ms_per_eval=sum(dev_us.values()) / 1e3 / iters,
                device_ms_by_class={k: v / 1e3 / iters
                                    for k, v in dev_us.items()})
            if mode == "kernels":
                counts = {ev.key: ev.count for ev in kernels}
                for name in ("gram_fwd_kernel", "gram_bwd_partial_kernel",
                             "gram_bwd_reduce_kernel"):
                    got = sum(c for k, c in counts.items() if name in k)
                    check(got == iters, f"census: {name} {got} launches in "
                          f"{iters} evaluations")
    finally:
        gk.KERNELS["matern52"] = on_path
    (f_k, g_k), (f_p, g_p) = results["kernels"], results["plain"]
    e_f = float(((f_k - f_p).abs() / f_p.abs()).max())
    e_g = float((g_k - g_p).abs().max() / g_p.abs().max())
    check(e_f <= 1e-10 and e_g <= 1e-8,
          f"census: kernel vs plain fit objective {e_f}, gradient {e_g}")
    rows.update(rel_err_value=e_f, rel_err_grad=e_g)
    log("[census] one MAP-fit evaluation, R=2 n=544 D=20: "
        + json.dumps(rows))
    return rows


# ---------------------------------------------------- slice 2: fused ask
ASK_KINDS = ("full", "incremental", "fallback")


class VetoAt:
    """Fault hook of AskEngine: vetoes the rank-one update of the k-th
    incremental attempt, forcing one Schur fallback to the full program."""

    def __init__(self, k: int):
        self.k, self.seen = k, 0

    def incr_ok(self, ok, tags):
        self.seen += 1
        return ok * 0 if self.seen == self.k else ok


def expected_launches(info):
    """K1–K4 launches one fused ask must make, from its own counts."""
    k3 = {"full": info.fit_evals + 1, "incremental": 1,
          "fallback": 1 + info.fit_evals + 1}[info.kind]
    return {"matern52_posterior_fwd": info.rounds,
            "matern52_posterior_bwd_xq": info.rounds,
            "matern52_gram_fwd": k3,
            "matern52_gram_bwd_theta": info.fit_evals}


def ask_row(s, wall_ms, delta):
    import numpy as np
    info = s.last_ask_info
    return dict(kind=info.kind, n=s._ask.n_obs, bucket=s._ask.bucket,
                wall_ms=wall_ms, fit_ms=info.fit_ms, mso_ms=info.mso_ms,
                fit_evals=info.fit_evals, rounds=info.rounds,
                median_iters=float(np.median(info.n_iters.cpu().numpy())),
                launches=delta)


def phase_ask(dev):
    """The fused dbe_vec ask at D=20, B=10 after 512 startup trials: a full
    refit (n=512), a bucket-growth refit (n=513 → 544), incremental asks, a
    vetoed (fallback) ask and an interval refit; exact launches per ask.
    The obs tracer is on for the asks, so that each ask's SuggestInfo
    carries its synchronized fit and MSO ms."""
    import numpy as np
    import torch
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import GPSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.gp.gpr import fit_gram, predict
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.obs import trace as obs

    D, B, N0, N_ASKS = 20, 10, 512, 11
    obj = make_objective("rastrigin", D)
    s = GPSampler(BoxSpace.cube(D, -5.0, 5.0), strategy="dbe_vec",
                  n_restarts=B, n_startup_trials=N0, seed=0)
    check(s.fused and s.device.type == "cuda"
          and s.posterior_backend == "fused",
          f"dbe_vec sampler: fused={s.fused} on {s.device} / "
          f"{s.posterior_backend}")
    for _ in range(N0):
        t = s.ask()
        s.tell(t.trial_id, obj(t.x))

    rows, incr_errs = [], []
    K.reset_launch_counts()
    # the path's launches: each ask's own, without the checks between asks
    launches = dict.fromkeys(K.LAUNCHES, 0)
    tracer = obs.enable()
    for i in range(N_ASKS):
        if i == 1:
            s._ask.fault_injector = VetoAt(3)
        before = K.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = s.ask()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = K.launch_counts()
        s.tell(t.trial_id, obj(t.x))
        check(bool(np.all(np.isfinite(t.x))) and t.x.shape == (D,)
              and bool(np.all((t.x >= -5) & (t.x <= 5))),
              f"fused ask {i}: bad suggestion {t.x}")
        delta = {k: after[k] - before[k] for k in after}
        for k in delta:
            launches[k] += delta[k]
        rows.append(ask_row(s, wall, delta))
        log(f"[ask] {i}: " + json.dumps(rows[-1]))
        want = expected_launches(s.last_ask_info)
        check(delta == want, f"fused ask {i}: launches {delta} != {want}")
        if rows[-1]["kind"] == "incremental":
            incr_errs.append(incremental_error(s, fit_gram, predict))
    obs.disable()
    log(f"[ask] launches over {N_ASKS} asks: {json.dumps(launches)}; "
        f"{len(tracer.events())} obs events")
    kinds = [r["kind"] for r in rows]
    check(kinds[:2] == ["full", "full"] and rows[1]["bucket"] == 544,
          f"first asks {kinds[:2]}: no full and bucket-growth refit")
    check(set(kinds) == set(ASK_KINDS), f"ask kinds {kinds}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the fused ask path was never launched")
    worst = max(incr_errs)
    check(worst <= 1e-8, f"incremental state vs from-scratch fit: {worst}")
    log(f"[ask] incremental state vs from-scratch fit at the same θ "
        f"({len(incr_errs)} asks): max |Δ| {worst:.3e} (≤1e-8)")
    by_kind = {}
    for k in ASK_KINDS:
        sel = [r for r in rows if r["kind"] == k]
        by_kind[k] = {f: [r[f] for r in sel] for f in
                      ("n", "wall_ms", "fit_ms", "mso_ms", "fit_evals",
                       "rounds")}
        log(f"[ask] {k}: " + json.dumps(by_kind[k]))
    snap = s._ask.stats_snapshot()
    log(f"[ask] programs: full {snap['n_full_compiles']} incr "
        f"{snap['n_incr_compiles']} retraces "
        f"{json.dumps(snap['retraces']['causes'])}")
    fused_equals_host()
    return s, obj, launches, rows, by_kind


def incremental_error(s, fit_gram, predict):
    """Largest difference of the rank-one state from a from-scratch fit at
    the same θ: the factor, α and K⁻¹ relative to their largest entry, and
    the posterior mean and variance at 64 points (absolute, O(1) values)."""
    import torch
    gp = s._ask.gp_state()
    n = s._ask.n_obs
    ref = fit_gram(gp.x_train[:n], gp.y_train[:n], gp.params)
    kinv_ref = torch.cholesky_inverse(ref.chol)
    xq = torch.rand((64, gp.x_train.shape[1]), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n)).to(
                        gp.x_train.device)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = [rel(gp.chol[:n, :n], ref.chol), rel(gp.alpha[:n], ref.alpha)]
    if gp.kinv is not None:
        errs.append(rel(gp.kinv[:n, :n], kinv_ref))
    errs += [float((a - b).abs().max())
             for a, b in zip(predict(gp, xq), predict(ref, xq))]
    return max(errs)


def fused_equals_host():
    """Fused == host dbe_vec bitwise on the card: D=3, refit_interval=1,
    no warm start, across a bucket boundary (n = 5..12, pads 8 and 16)."""
    import numpy as np
    from repro_torch.bo.sampler import GPSampler
    from repro_torch.bo.space import BoxSpace

    def sphere(x):
        return float(np.sum((x - 0.4) ** 2))

    xs = []
    for fused in (False, True):
        h = GPSampler(BoxSpace.cube(3, -1.0, 1.0), strategy="dbe_vec",
                      n_startup_trials=5, n_restarts=6, pad_multiple=8,
                      seed=3, fused=fused, refit_interval=1,
                      warm_start=False)
        out = []
        for _ in range(13):
            t = h.ask()
            h.tell(t.trial_id, sphere(t.x))
            out.append(t.x)
        xs.append(np.array(out))
    check(np.array_equal(xs[0], xs[1]),
          f"fused != host: max |Δ| {np.abs(xs[0] - xs[1]).max()}")
    log("[ask] fused == host dbe_vec bitwise on the card (D=3, 13 trials, "
        "buckets 8 and 16)")


def timed_ask(s, obj):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = s.ask()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    s.tell(t.trial_id, obj(t.x))
    return wall_ms


DEVICE_CLASSES = (
    ("k1", ("posterior_fwd_kernel",)),
    ("k2", ("posterior_bwd_xq_kernel",)),
    ("k3", ("gram_fwd_kernel",)),
    ("k4", ("gram_bwd_partial_kernel", "gram_bwd_reduce_kernel")),
    ("memcpy", ("memcpy",)),
    ("chol_solve", ("potrf", "potrs", "trsm", "trsv", "cholesky", "magma",
                    "cusolver", "syrk", "herk", "trtri")),
)


def device_breakdown(prof):
    """Device µs of one trace by kernel class (first match of the kernel's
    name, case-insensitive; the rest is "other")."""
    dev_us = {name: 0.0 for name, _ in DEVICE_CLASSES}
    dev_us["other"] = 0.0
    for ev in prof.key_averages():
        us = _device_us(ev)
        if us <= 0:
            continue
        key = ev.key.lower()
        cls = next((name for name, pats in DEVICE_CLASSES
                    if any(p in key for p in pats)), "other")
        dev_us[cls] += us
    return dev_us


def traced_ask(s, obj, untraced_ms):
    """One ask traced on the card alone (no host-op events), with the
    clock inside the trace: device ms by kernel class against the ask's
    wall.  The tracer adds host time, so the traced idle share is an upper
    bound; ``untraced_ms`` (an ask of the same kind and n bucket, not
    traced) gives the estimate 1 − busy / untraced wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fit0, mso0 = s.stats.fit_time, s.stats.acqf_time
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t = s.ask()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    s.tell(t.trial_id, obj(t.x))
    dev_us = device_breakdown(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    row = dict(untraced_ask_ms=untraced_ms, wall_ms=wall_ms,
               fit_host_ms=(s.stats.fit_time - fit0) * 1e3,
               mso_host_ms=(s.stats.acqf_time - mso0) * 1e3,
               device_ms={k: v / 1e3 for k, v in dev_us.items()},
               device_busy_ms=busy_ms)
    check(busy_ms > 0, "profiler saw no device time")
    row["device_idle_share_traced"] = 1.0 - busy_ms / wall_ms
    row["device_idle_share_est"] = max(0.0, 1.0 - busy_ms / untraced_ms)
    return row


def phase_breakdown(s, obj):
    """Slice 1's host-path ask: the ask just before the traced one, same
    n bucket, is the untraced reference."""
    row = traced_ask(s, obj, timed_ask(s, obj))
    row.update(n=int(s.last_acq_state[0].x_train.shape[0]),
               rounds=s.last_mso.n_rounds)
    log("[breakdown] host dbe ask: " + json.dumps(row))
    return row


def phase_ask_breakdown(s, obj, rows):
    """The fused sampler after the ask phase: its next ask is incremental
    and the one after an interval refit (full), both at bucket 544; the
    untraced references are the ask phase's asks of the same kind there
    (profiler off, obs tracer on, as here)."""
    import numpy as np
    from repro_torch.obs import trace as obs
    out = {}
    obs.enable()
    for _ in range(2):
        nxt = ("incremental" if s._ask._since_refit
               < s._ask.cfg.refit_interval - 1 else "full")
        ref = [r["wall_ms"] for r in rows
               if r["kind"] == nxt and r["bucket"] == 544]
        row = traced_ask(s, obj, float(np.median(ref)))
        info = s.last_ask_info
        check(info.kind == nxt, f"traced ask is {info.kind}, not {nxt}")
        row.update(kind=info.kind, n=s._ask.n_obs, rounds=info.rounds,
                   fit_evals=info.fit_evals, fit_ms=info.fit_ms,
                   mso_ms=info.mso_ms)
        log(f"[breakdown] fused {info.kind} ask: " + json.dumps(row))
        out[info.kind] = row
    obs.disable()
    return out


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


def phase_gram_timing(dev):
    """K3/K4 and their plain versions at the MAP fit's shape (R=2, n=544,
    D=20, the bucket's 32 _FAR rows included) and at n=2048."""
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                                matern52_gram_ref)
    rows = []
    for n, iters in ((544, 200), (2048, 20)):
        x1, x2, ils, amp, g = gram_inputs(n, n, 20, 2, dev, far=32)
        calls = {
            "gram_fwd": lambda: K.matern52_gram_fwd(x1, x2, ils, amp),
            "gram_fwd_plain": lambda: matern52_gram_ref(x1, x2, ils, amp),
            "gram_bwd": lambda: K.matern52_gram_bwd_theta(x1, x2, ils, amp,
                                                          g),
            "gram_bwd_plain": lambda: matern52_gram_bwd_theta_ref(
                x1, x2, ils, amp, g)}
        row = dict(n=n, D=20, R=2)
        for key, fn in calls.items():
            row[f"{key}_ms"] = device_time_ms(fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        fb, fby = bound_ms(*gram_cost(2, n, n, 20, False))
        bb, bby = bound_ms(*gram_cost(2, n, n, 20, True))
        row.update(gram_fwd_bound_ms=fb, gram_fwd_bound_by=fby,
                   gram_bwd_bound_ms=bb, gram_bwd_bound_by=bby)
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
    phase_gram_kernels(dev, err)
    sampler, obj, launches1, per_ask, c3, state = phase_main(dev)
    from repro_torch.engine.plan import EvalPlan
    plan = EvalPlan.for_batch(sampler.B, sampler.space.dim,
                              bucketed=sampler.mso_options.bucketed)
    phase_main_shapes(state, plan.buckets, err)
    asker, obj2, launches, ask_rows, _ = phase_ask(dev)
    phase_ask_shapes(asker, err)
    phase_fit_census(dev)
    phase_breakdown(sampler, obj)
    phase_ask_breakdown(asker, obj2, ask_rows)
    timing = phase_timing(dev, state)
    gram_timing = phase_gram_timing(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    # the main paths' shapes: posterior q = B = 10 at n = 544, D = 20;
    # gram R = 2 (gp_fit_restarts) at n = 544, D = 20
    rows = {"fwd": timing[1], "bwd": timing[1],
            "gram_fwd": gram_timing[0], "gram_bwd": gram_timing[0]}
    kernels = []
    for name, key, src, replaces in (
            ("matern52_posterior_fwd", "fwd",
             "src/repro_torch/kernels/matern/csrc/posterior.cu",
             "src/repro/kernels/matern/kernel.py:132"),
            ("matern52_posterior_bwd_xq", "bwd",
             "src/repro_torch/kernels/matern/csrc/posterior.cu",
             "src/repro/kernels/matern/ops.py:50"),
            ("matern52_gram_fwd", "gram_fwd",
             "src/repro_torch/kernels/matern/csrc/gram.cu",
             "src/repro/kernels/matern/kernel.py:48"),
            ("matern52_gram_bwd_theta", "gram_bwd",
             "src/repro_torch/kernels/matern/csrc/gram.cu",
             "src/repro/kernels/matern/kernel.py:48")):
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[key], "ms": row[f"{key}_ms"],
            "plain_ms": row[f"{key}_plain_ms"],
            "bound_ms": row[f"{key}_bound_ms"],
            "bound_by": row[f"{key}_bound_by"], "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
