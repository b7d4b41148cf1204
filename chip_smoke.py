"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. build    compile the CUDA kernels from src/repro_torch/.../csrc (one
              nvcc for each source, all started together) and link them
              into one library
  2. kernels  hold K1 (matern52_posterior_fwd) and K2
              (matern52_posterior_bwd_xq) against their plain PyTorch
              versions on the card at n ∈ {32, 33, 63, 64, 65, 512, 513,
              2048} (ragged chunks and tiles; q = 1000 walks from n = 513
              on) and D ∈ {5, 20, 40, 300} (D = 300 in pieces, K1 split),
              and check batch-width independence bitwise (row 0 alone, in
              a batch of 10 and in a batch of 1000, across K1's regimes
              and K2's rows a block);
              then K3 (matern52_gram_fwd) and K4 (matern52_gram_bwd_theta)
              at n ∈ {32, 544, 2048}, D ∈ {5, 20, 40}, R ∈ {1, 2}, the
              n1 = 1 cross column and _FAR rows, x1 is x2 (the fit's
              symmetric path) against x2 a copy (the cross path): K3
              bitwise equal, bitwise symmetric, column = row, θ rows
              bitwise at R = 1 and 2; D ∈ {300, 1000} at n = 544
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
  6. timing   device times (profiler; CUDA events where a trace is
              short, marked "events") and CUDA-event call times of K1–K4
              and their plain versions beside the least time the card
              could take (bound); K1's regime and the device µs of each
              kernel its trace holds (all in the K1 class), and K2's
              (all in the K2 class); K3/K4 at the fit's call (x1 is x2),
              the cross path and the n1 = 1 column, and K4's µs by kernel
Slice 3 adds, in the same run:
  - build     the flash (K6) and kvp (K5) sources join the one library
  - kernels   K6 flash_attention_fwd against its plain version on the
              Pallas test cases (through flash_attention; window 0
              masks every key, as in the Pallas kernel), GQA decode
              (B=8, NH=24, KH=8, hd=128, Sk ∈ {512, 513, 4095, 4096},
              ragged positions, empty slots, a trash slot, an idle row),
              rows whose keys lie in one split only and a row with no
              visible key in any split, a windowed prefill chunk over a
              cache (split path, f32; MMA path, bf16), bf16 rows Sq·G ∈
              {63, 64, 65} at G=1 and {63, 66} at G=3 around the MMA
              threshold at hd ∈ {64, 128}, and a causal prefill through
              flash_attention_bhsd (H=24, hd=128: S=512 and 2048 in
              f32 as one split, S=2048 in bf16 on the MMA path), with
              row independence bitwise;
              a recurrentgemma-9b decode at hd=256 (B=8, NH=16, KH=1,
              Sk=2048, window 2048) in bf16 and f32;
              bf16 within one bf16 ulp of each entry; K5 kvp_fwd at the
              Pallas test shapes, (10, 544, 20) and (1000, 2048, 20), D = 300 and 1000 (_FAR rows from n = 544): within
              1e-12 of Σ|terms|, bitwise K1's mean, the first 1, 10 and
              17 rows alone bitwise those of the batch (8 and 32 queries
              a block)
  - kvp       gp_mean_kvp on the fused ask's fitted state (K5 launches)
  - serve     ServeEngine on llama3.2-3b at full width (bf16, weights
              drawn on the card from the seed), 8 slots, max_len 512, 16
              requests with 16–128-token prompts and 32 new tokens: K6
              launches = 28 × steps, one program, tokens/s, ms per step,
              parameter GB, cache MB, K6 device time per step and the idle
              share; staggered and chunked prefill bitwise equal to solo
              runs; decode vs forward logits over 64 tokens; the card
              against the CPU on the reduced config in f32
  - timing    K5/K6 and their plain versions beside their bounds, and
              scaled_dot_product_attention at K6's shapes (timed only):
              K6 at decode Sk ∈ {512, 4096}, at a serving step (8 slots,
              positions 64–104 in a 512-slot cache) and at the causal
              prefill S=2048, with the K6 kernels each trace holds (the
              prefill's must be the MMA kernel); K5's geometry and its
              two kernels' µs
Slice 4 adds, in the same run:
  - fleet kernels  K1–K4 with a leading study axis at S ∈ {1, 3, 8},
              n ∈ {33, 544}, D ∈ {5, 20}, each study with its own θ and
              its own count of _FAR rows: one launch a call, each study's
              slice bitwise its solo call and within the plain versions'
              tolerances
  - fleet     FleetSampler at full width: 16 Rastrigin studies (D=20,
              seeds 0–15) on two 8-slot blocks, B=10, R=2, refit every
              8th trial, 542 random trials then 8 rounds across the
              544 → 576 bucket: K1 = K2 launches = MSO rounds summed over
              blocks, K4 = fit evaluations, K3 = evaluations + full and
              rank-one programs, ≤ 3 programs per (bucket, slots); round
              0 against each study's solo programs layer by layer, all
              bitwise (one MAP-objective evaluation, value and
              θ-gradient; the refit's θ, Cholesky factor, α and K⁻¹;
              the MSO from the fleet's fitted state); every study within
              1e-10 of its solo fused GPSampler end to end over the
              first 4 rounds (full, rank-one, and the migration's full
              refit), suggests/s beside the 16 run solo in turn;
              a rank-one and a full round traced (host ms, device ms,
              idle share); slot permutation and solo-in-a-block bitwise on
              a 3-study fleet (D=20, n=40); a 2-study fleet (D=5,
              refit_interval=1) killed mid-journal and recovered, bitwise
  - fleet timing  K1–K4's device µs at the fleet's shapes (S=8, q=10,
              n=544, D=20; K3/K4 R=2) beside their bounds and 8 × the
              solo call; the "kernels" line adds them to K1–K4 with the
              fleet path's launches
Slice 5 adds, in the same run:
  - paper     the twins of the paper's examples (examples/*_torch.py):
              batched Rosenbrock (B=10, D=5) through maximize_acqf with
              no state, i.e. the default engine on the card, 3 times:
              C3 bitwise (x, n_iters, n_evals), C2's inflation, median
              rounds and wall ms of SEQ, D-BE, C-BE and dbe_vec; the same
              four on the main phase's fitted GP state; the lockstep
              solve's dense inverse Hessian against the two-loop columns
              (1e-12) and dense BFGS on the Rosenbrock batch; a q=2
              qLogEI MSO on the GP state (finite, in bounds); the
              quickstart twin (K1 = K2 = MSO rounds, K3 = K4 + fits) and
              the serve twin (K6 = layers × steps), counted alone
Slice 6 adds, in the same run:
  - service   BOService over a FleetSampler at the fleet phase's width (16
              Rastrigin studies, D=20, two 8-slot blocks, B=10, R=2,
              refit every 8th trial, 542 random trials through the
              service's sync core), tenants gold (weight 4, studies 0–3,
              2 GP rounds), silver (2, 4–9, 2) and bronze (1, 10–15, 1)
              as asyncio coroutines beside svc.run() on the real clock:
              every ask served, rung admit, K1 = K2 = MSO rounds, K4 = fit
              evaluations, K3 = evaluations + full + rank-one programs,
              ≤ 3 programs per (bucket, slots); study 0's first GP ask
              shed in flight by a 1 s deadline and asked again; the same
              schedule driven directly through FleetSampler.ask_batch,
              bitwise; suggests/s of both, each tenant's share and ask
              p50/p99, host ms a service_step beyond its fleet.step; the
              snapshot schema, the Prometheus scrape, the journal's
              timeline; a traced round (Chrome trace, svc.* and fleet.*
              spans, device busy and idle share, programs unchanged) and
              a guarded round (install_nan_guard: one check a program
              call, no trip, snapshots and programs unchanged, its cost);
              `python -m repro_torch.obs overhead`; on small fleets (D=5)
              the overload ladder under a virtual clock (admit → reject →
              degrade → shed_tenant → admit, the degraded tenant on the
              solo fused ask with its launches counted), the NaN guard
              tripping on a poisoned block, and a 2-tenant service killed
              mid-journal and recovered with BOService.recover, bitwise;
              the "kernels" line adds K1–K4's service launches
Slice 7 adds, in the same run:
  - families  after serve: ServeEngine on qwen3-moe-30b-a3b (full width,
              8 of 48 layers since PR 25, 128 experts top-8, qk-norm; the
              expert weights drawn in place, the init's peak memory
              logged), chameleon-34b's backbone (full width, 4 of 48
              layers) and recurrentgemma-9b (full width, 8 of 38 layers
              since PR 25: 2 (rec, rec, attn) triples and 2 recurrent
              layers, window 2048), bf16, each with serve's traffic:
              parameters counted by element, every request decodes 32
              tokens, K6 launches =
              attention layers × steps, one program; tokens/s, ms a step,
              steady decode's K6, product and busy device ms and idle
              share beside the step's bound (its weight bytes over 3.35
              TB/s); decode vs forward logits over 64 tokens (qwen3 at
              capacity factor 100; a routing flip must be a near tie);
              staggered and chunked prefill bitwise solo (chameleon;
              qwen3 at capacity factor 100; not recurrentgemma, whose
              reference lacks the property: ROADMAP C17); the card
              against the CPU on each reduced config in f32 (qwen3 at the
              published capacity factor, recurrentgemma past its window
              of 64)
  - timing    K6 at the qwen3 and recurrentgemma serving steps beside its
              plain version, SDPA and the bound; the "kernels" line adds
              K6's launches on the three paths and these rows
Slice 8 adds, in the same run:
  - families  xlstm-1.3b (ssm: full width, 2 of 6 groups of 7 mLSTM
              + 1 sLSTM blocks since PR 25, bf16) with serve's traffic:
              parameters by element, the cache's bytes at 8 slots,
              no K6 launch, one program; steady decode's busy, cuBLAS and
              other device ms beside the step's bound (weights plus the
              states read and written once); decode (step form) vs
              forward (chunkwise form) logits over 64 tokens within 5e-2;
              no staggered-equals-solo check (C17); the card against the
              CPU on the reduced config (two mLSTM chunks)
  - whisper   whisper-base at full width (6 + 6 layers, bf16): 8 clips of
              1500 stub frames through encode, init_cache(max_len=448), 4
              prompt tokens then greedy tokens until 64 are chosen through
              decode_step: K6 launches = 6 an encode + 12 a step; decode
              vs decode_train logits over 64 tokens within 5e-2; the MMA
              kernel in the encoder's and decode_train's traces, the
              split kernels in a step's; 20 steps traced beside the step's
              bound; the card against the CPU on the reduced config in
              f32 (100 frames)
  - whisper kernels  K6 against its plain version at whisper's four calls
              (encoder Sq=Sk=1500 and decode_train's cross-attention
              Sq=64 over 1500, both not causal, MMA path; a step's
              cross-attention Sq=1 over 1500 in splits of 256 and its
              causal self-attention over a 448-slot cache, split path),
              each beside its plain version, SDPA and the bound; the
              "kernels" line adds whisper's launches and these rows
Slice 9 adds, in the same run, after the service:
  - train kernels  K6 with its log-sum-exp and K7 (flash_attention_bwd)
              against their plain versions at every attention a family's
              training runs: llama3.2-3b's step (B=4, S=512, NH=24, KH=8,
              hd=128, bf16, causal, MMA forward), f32 hd 64 at S=300 with
              window 128, qwen3's G=8, recurrentgemma's NH=16, KH=1, hd
              256 with window 2048 at S=2560, whisper's encoder (S=1500,
              not causal) and cross-attention (Sq=64 over 1500), and a
              call where no query sees a key (window 0, causal): lse
              within 1e-4 (+inf where no key is seen), K6's output bits
              unchanged with lse, K7 within 1e-4 of each gradient's max
              (+ one bf16 rounding), bitwise from run to run, exact zeros
              where no pair is seen; at the slice's shape the device and
              call ms of K6 with and without lse, K7 and their plain
              versions, SDPA's forward and backward (timed only) and the
              bounds
  - train     llama3.2-3b at full width through train_step (weights drawn
              once on the card, stacked; B=4, S=512, AdamW lr 3e-4, wd
              0.1, 8 steps, 1 of warmup): finite falling loss, 28 K6 and
              28 K7 launches a step, ms a step, tokens/s, MFU, peak
              memory, 3 steps traced (K6, K7, cuBLAS, other, busy, idle),
              the gradients and the update apart; the six families'
              reduced configs (llama, qwen3-moe, chameleon with stub
              embeddings, recurrentgemma, xlstm, whisper) one step on the
              card against the CPU in f32, and llama with grad_accum 2
              and with bf16 gradients; the reduced llama through
              launch/train.main: 6 steps straight = 3, checkpoint,
              resume to 6, bitwise; the hpo_train twin (K1–K4 in the
              sampler, K6 = K7 = 2 × steps × trials); the "kernels" line
              adds K7 and K6's train launches and timing
Slice 11 adds, in the same run:
  - families  chatglm3-6b (partial rotary), starcoder2-15b (layernorm
              with bias, ungated GELU) and deepseek-7b (full MHA) at full
              width, 8 layers each, with serve's traffic and checks
  - train remat  llama3.2-3b at full width and depth, bf16, B=8, S=512:
              one compute_grads under remat none, full and dots on the
              same parameters and batch: loss and gradients bitwise, each
              mode's ms and peak memory (full's below none's), K6 = 28 or
              56 and K7 = 28; then 8 train steps under full remat and 3
              traced (K6 = 56, K7 = 28 a step; ms, tokens/s, MFU, peak,
              K6/K7/cuBLAS/other device ms); the dry run's bytes held
              (launch/dryrun.py) for this cell and for the B=4 remat-none
              one beside the measured peaks; the "kernels" line adds K6's
              and K7's launches here.  The B=4 train row stays at remat
              "none", the setting its earlier readings were taken at
Every timing line carries the card's name and power limit.
Then it prints the card, a "kernels" JSON line (each "ms" with its
source, "ms_from"; K6 at the serving step's shape), and the result line.
Exits with 2, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
    # the card's rates (H100 SXM data sheet: HBM3 3.35 TB/s, bf16 989
    # TFLOP/s on the tensor cores) and K6's and K7's costs, one source
    # with the dry run's roofline
    from repro_torch.kernels.flash.cost import flash_bwd_cost, flash_cost
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S

# f64 67 TFLOP/s on the tensor cores (matrix products) and 34 TFLOP/s on
# the CUDA cores (the elementwise rest)
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


PAD_KERNEL = "spin_kernel"        # torch.cuda._sleep's kernel
PAD_S = 0.02                      # host seconds of padding a trace starts with


def _device_us(ev) -> float:
    """Device µs of a trace's event; 0 for card_trace's padding."""
    if PAD_KERNEL in ev.key:
        return 0.0
    return float(getattr(ev, "self_device_time_total", 0.0) or
                 getattr(ev, "self_cuda_time_total", 0.0) or 0.0)


@contextlib.contextmanager
def card_trace():
    """A torch.profiler trace of the card.  A trace can miss the first
    few launches after it starts (1–5 of them on the H100: 0.5–50 % of a
    short trace's device time), so the trace starts with PAD_S seconds of
    short spin kernels, each waited for, to take that loss, and ends
    with a few more; ``_device_us`` leaves the padding out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def pad(seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad(PAD_S)
        yield prof
        torch.cuda.synchronize()
        pad(PAD_S / 4)


def _trace(fn, iters: int):
    """{kernel or copy: (launches, device µs)} over ``iters`` calls, from
    a card_trace."""
    import torch
    for _ in range(3):
        fn()
    with card_trace() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: (ev.count, _device_us(ev)) for ev in prof.key_averages()
            if _device_us(ev) > 0}


def device_ms(fn, iters: int):
    """(ms per call, source).  The source is "profiler": the sum of every
    kernel and copy the call runs on the card, from a trace of ``iters``
    calls, which leaves out the gaps while the card waits for the host.
    A call launches the same kernels each time, so a complete trace holds
    each of them a multiple of ``iters`` times.  Where a trace is short
    all the same, the source is "events": a CUDA-event pair around
    back-to-back calls, launch gaps included."""
    trace = _trace(fn, iters)
    if trace and all(n % iters == 0 for n, _ in trace.values()):
        return sum(us for _, us in trace.values()) / 1e3 / iters, "profiler"
    log(f"[timing] profiler trace incomplete over {iters} calls "
        f"(launches {json.dumps({k[:48]: n for k, (n, _) in trace.items()})}"
        f"); timing with CUDA events")
    return cuda_time_ms(fn, iters), "events"


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


def kvp_cost(q, n, d):
    """The same for K5: xq, xt, α, 1/ℓ and σ_f² read, the means written;
    the products a·bᵀ, then ~15 elementwise operations an entry."""
    return 8 * (q * d + n * d + n + d + 1 + q), 2 * q * n * d, 15 * q * n


def bound_ms(nbytes, mma_ops, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mma_ops / F64_MMA_FLOP_PER_S + ops / F64_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    log(f"[build] {len(_build.SOURCES)} sources "
        f"({', '.join(s.name for s in _build.SOURCES)}) → "
        f"{os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


def check_against_plain(gp, q, rng, err, tag, xq=None):
    """K1 and K2 against their plain versions on the same CUDA tensors, at
    q queries (the first on a training point) or at ``xq``; errors go
    into ``err``."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_posterior_bwd_ref,
                                                matern52_posterior_fwd_ref)
    n, d = gp.x_train.shape
    dev = gp.x_train.device
    args = kernel_args(gp)
    amp = float(gp.params.amplitude)
    var_tol = 8 * n * EPS64 * amp * amp * float(gp.kinv.abs().max())
    if xq is None:
        xq = torch.as_tensor(rng.uniform(0, 1, (q, d))).to(dev)
        xq[0] = gp.x_train[0]                    # a query on a train point
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
    (as the evaluator pads) vs in a batch of 1000 (K1's walk regime at
    n ≥ 513): bitwise the same outputs.  Returns K1's regimes."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    n, d = gp.x_train.shape
    args = kernel_args(gp)
    xq = torch.as_tensor(rng.uniform(0, 1, (1000, d))).to(gp.x_train.device)
    xb = torch.cat([xq[:7], xq[6:7].expand(3, d)], 0).contiguous()
    outs = []
    for x in (xq[:1].contiguous(), xb, xq):
        m, v, t = K.matern52_posterior_fwd(x, *args)
        ones = torch.ones_like(m)
        g = K.matern52_posterior_bwd_xq(x, args[0], args[1], t, v, args[3],
                                        args[4], ones, -0.5 * ones)
        outs.append((m, v, t, g))
    for other, q in ((outs[1], 10), (outs[2], 1000)):
        for a, b in zip(outs[0], other):
            check(torch.equal(a[0], b[0]), f"{tag}: row 0 differs in a "
                  f"batch of {q} (K1 {K.plan(q, n, d).regime})")
    for b in outs[1]:
        check(torch.equal(b[6], b[9]), f"{tag}: repeated row differs")
    return [K.plan(q, n, d).regime for q in (1, 10, 1000)]


def phase_kernels(dev):
    import numpy as np
    err = {"fwd": 0.0, "bwd": 0.0}
    rng = np.random.default_rng(7)
    for n in (32, 33, 63, 64, 65, 512, 513, 2048):
        for d in (5, 20, 40, 300):
            gp = make_state(n, d, seed=n + d, device=dev)
            for q in (1, 10, 1000):
                check_against_plain(gp, q, rng, err, f"n={n} D={d} q={q}")
            regimes = check_batch_width(gp, rng, f"n={n} D={d}")
        log(f"[kernels] n={n}: K1 regimes at q = 1, 10, 1000: {regimes}")
    log(f"[kernels] batch-width independence (1, 10, 1000): bitwise  max "
        f"abs err fwd {err['fwd']:.3e} bwd {err['bwd']:.3e}")
    return err


def phase_main_shapes(state, buckets, err):
    """K1/K2 against their plain versions on the state the main path's
    last ask evaluated, at every batch bucket its evaluator pads to."""
    import numpy as np
    from repro_torch.kernels.matern import kernel as K
    gp = state[0]
    n, d = gp.x_train.shape
    rng = np.random.default_rng(17)
    for q in buckets:
        check_against_plain(gp, q, rng, err, f"main state n={n} D={d} q={q}")
    check_batch_width(gp, rng, f"main state n={n} D={d}")
    log(f"[kernels] main-path shapes (buckets {list(buckets)}, K1 "
        f"{sorted({K.plan(q, n, d).regime for q in buckets})}): within "
        f"tolerance, batch width (1, 10, 1000) bitwise")


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
        log(f"[main] ask {i}: " + json.dumps(on_card(per_ask[-1])))
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
    log("[main] C3 bitwise (n_iters, n_evals, x): "
        + json.dumps(on_card(c3)))

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
    """x1 (n1, D), x2 (n2, D) in the unit cube, the last ``far`` rows of x2
    replaced by _FAR pseudo-points, 1/ℓ in [e⁻¹, e⁴] (R, D), σ_f² (R,) and
    an upstream Ḡ (R, n1, n2) that, as in the masked LML, is 0 on entries
    of _FAR rows.  Where n1 = n2, x1 is x2: one tensor, as the fit passes
    it (K3/K4's symmetric path)."""
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
    x1, x2, ils, amp, g = (torch.tensor(v, device=device)
                           for v in (x1, x2, ils, amp, g))
    return (x2 if n1 == n2 else x1), x2, ils, amp, g


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


def check_gram_paths(tag, inputs, far, err):
    """K3/K4's symmetric path (x1 is x2, ``inputs``' own) against the
    cross path (x2 a copy): the cross path within tolerance too; K3 the
    same bits on both, bitwise symmetric, its n1 = 1 column k(x_i, X)
    bitwise row i; each θ row of K3 and K4 the same bits at R = 1 as at
    R = 2, on both paths."""
    import torch
    from repro_torch.kernels.matern import kernel as K
    x, _, ils, amp, g = inputs
    n, r = x.shape[0], ils.shape[0]
    xc = x.clone()
    check(K.same_points(x, x) and not K.same_points(x, xc),
          f"{tag}: sameness check")
    check_gram(f"{tag} cross", (x, xc, ils, amp, g), far, err)
    k = {"same": K.matern52_gram_fwd(x, x, ils, amp),
         "copy": K.matern52_gram_fwd(x, xc, ils, amp)}
    bwd = {"same": K.matern52_gram_bwd_theta(x, x, ils, amp, g),
           "copy": K.matern52_gram_bwd_theta(x, xc, ils, amp, g)}
    check(torch.equal(k["same"], k["copy"]),
          f"{tag}: K3 symmetric path != cross path bitwise")
    check(torch.equal(k["same"], k["same"].transpose(1, 2)),
          f"{tag}: K3 not bitwise symmetric")
    for i in (0, n // 2, n - 1):
        col = K.matern52_gram_fwd(x[i:i + 1], x, ils, amp)
        check(torch.equal(col[:, 0], k["same"][:, i]),
              f"{tag}: K3 column {i} != row {i} of the gram")
    for path, x2 in (("same", x), ("copy", xc)):
        for i in range(r):
            one = (ils[i:i + 1].contiguous(), amp[i:i + 1].contiguous())
            k1 = K.matern52_gram_fwd(x, x2, *one)
            di, da = K.matern52_gram_bwd_theta(x, x2, *one,
                                               g[i:i + 1].contiguous())
            check(torch.equal(k1[0], k[path][i]),
                  f"{tag} {path}: K3 θ row {i} differs at R=1")
            check(torch.equal(di[0], bwd[path][0][i])
                  and torch.equal(da[0], bwd[path][1][i]),
                  f"{tag} {path}: K4 θ row {i} differs at R=1")


def phase_gram_kernels(dev, err):
    err.update(gram_fwd=0.0, gram_bwd=0.0)
    for n in (32, 544, 2048):
        far = 32 if n >= 544 else 0
        for d in (5, 20, 40):
            for r in (1, 2):
                check_gram(f"gram n={n} D={d} R={r} far={far}",
                           gram_inputs(n, n, d, r, dev, far), far, err)
        check_gram_paths(f"gram n={n} D=20 R=2 far={far}",
                         gram_inputs(n, n, 20, 2, dev, far), far, err)
        # the incremental refit's cross column k(x_new, X): n1 = 1, R = 1
        e = check_gram(f"gram n1=1 n2={n} D=20 far={far}",
                       gram_inputs(1, n, 20, 1, dev, far), far, err)
        log(f"[kernels] gram n={n}: D ∈ (5, 20, 40), R ∈ (1, 2) and the "
            f"n1=1 column within tolerance (column: K3 |Δ| {e[0]:.3e}, "
            f"K4 |Δ| {e[2]:.3e}); x1 is x2 and a copy: K3 bitwise equal "
            f"and symmetric, column = row, θ rows bitwise at R=1 and 2")
    for d in (300, 1000):              # D in pieces of 64 coordinates
        check_gram(f"gram n=544 D={d} R=2 far=32",
                   gram_inputs(544, 544, d, 2, dev, 32), 32, err)
        check_gram(f"gram n1=1 n2=544 D={d} far=32",
                   gram_inputs(1, 544, d, 1, dev, 32), 32, err)
    log("[kernels] gram D ∈ (300, 1000) at n=544 within tolerance")
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
            with card_trace() as prof:
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
                for name in ("gram_fwd_kernel", "gram_bwd_kernel",
                             "gram_bwd_merge_kernel"):
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
        log(f"[ask] {i}: " + json.dumps(on_card(rows[-1])))
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
        log(f"[ask] {k}: " + json.dumps(on_card(by_kind[k])))
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
    ("k1", ("posterior_fwd_split_kernel", "posterior_fwd_walk_kernel",
            "posterior_fwd_merge_kernel", "posterior_fwd_merge_walk_kernel")),
    ("k2", ("posterior_bwd_split_kernel", "posterior_bwd_merge_kernel")),
    ("k3", ("gram_fwd_kernel",)),
    ("k4", ("gram_bwd_kernel", "gram_bwd_merge_kernel")),
    ("memcpy", ("memcpy",)),
    ("chol_solve", ("potrf", "potrs", "trsm", "trsv", "cholesky", "magma",
                    "cusolver", "syrk", "herk", "trtri")),
)


def device_breakdown(prof):
    """Device µs of one trace by kernel class (first match of the kernel's
    name, case-insensitive; the rest is "other").  It reads the trace's
    device events (kernels, copies, sets) as they come: a traced fleet
    round holds over a hundred thousand, and ``key_averages`` first
    builds and groups an event object for each, which took ~170 s of the
    fleet phase's two traced rounds."""
    from torch.autograd import DeviceType
    dev_us = {name: 0.0 for name, _ in DEVICE_CLASSES}
    dev_us["other"] = 0.0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or PAD_KERNEL in ev.name():
            continue
        key = ev.name().lower()
        cls = next((name for name, pats in DEVICE_CLASSES
                    if any(p in key for p in pats)), "other")
        dev_us[cls] += ev.duration_ns() / 1e3
    return dev_us


def traced_ask(s, obj, untraced_ms):
    """One ask traced on the card alone (no host-op events), with the
    clock inside the trace: device ms by kernel class against the ask's
    wall.  The tracer adds host time, so the traced idle share is an upper
    bound; ``untraced_ms`` (an ask of the same kind and n bucket, not
    traced) gives the estimate 1 − busy / untraced wall."""
    import torch
    fit0, mso0 = s.stats.fit_time, s.stats.acqf_time
    with card_trace() as prof:
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
    log("[breakdown] host dbe ask: " + json.dumps(on_card(row)))
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
        log(f"[breakdown] fused {info.kind} ask: "
            + json.dumps(on_card(row)))
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
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        fb, fby = bound_ms(*fwd_cost(q, n, d))
        bb, bby = bound_ms(*bwd_cost(q, n, d))
        row.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
                   bwd_bound_by=bby, fwd_regime=K.plan(q, n, d).regime,
                   fwd_kernel_us=kernel_us(calls["fwd"], "posterior_fwd",
                                           iters),
                   bwd_rows=K.bwd_plan(q, n, d).rows,
                   bwd_kernel_us=kernel_us(calls["bwd"], "posterior_bwd",
                                           iters))
        for key, cls in (("fwd", "k1"), ("bwd", "k2")):
            us = row[f"{key}_kernel_us"]
            check(us and all(k in dict(DEVICE_CLASSES)[cls] for k in us),
                  f"{cls.upper()}'s trace holds {list(us)}, not its class")
        rows.append(row)
        log("[timing] " + json.dumps(on_card(row)))
    return rows


def phase_gram_timing(dev):
    """K3/K4 and their plain versions at the MAP fit's call (R=2, n=544,
    D=20, the bucket's 32 _FAR rows included, x1 is x2: the symmetric
    path) and at n=2048; at n=544 also the cross path (x2 a copy) and the
    rank-one refit's column (n1 = 1, R = 1)."""
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                                matern52_gram_ref)
    rows = []
    for n, iters in ((544, 200), (2048, 20)):
        x, _, ils, amp, g = gram_inputs(n, n, 20, 2, dev, far=32)
        calls = {
            "gram_fwd": lambda: K.matern52_gram_fwd(x, x, ils, amp),
            "gram_fwd_plain": lambda: matern52_gram_ref(x, x, ils, amp),
            "gram_bwd": lambda: K.matern52_gram_bwd_theta(x, x, ils, amp, g),
            "gram_bwd_plain": lambda: matern52_gram_bwd_theta_ref(
                x, x, ils, amp, g)}
        if n == 544:
            xc, xi = x.clone(), x[n - 33:n - 32]
            il1, amp1 = ils[:1].contiguous(), amp[:1].contiguous()
            calls.update({
                "gram_fwd_cross": lambda: K.matern52_gram_fwd(x, xc, ils,
                                                              amp),
                "gram_bwd_cross": lambda: K.matern52_gram_bwd_theta(
                    x, xc, ils, amp, g),
                "gram_fwd_column": lambda: K.matern52_gram_fwd(xi, x, il1,
                                                               amp1),
                "gram_fwd_column_plain": lambda: matern52_gram_ref(
                    xi, x, il1, amp1)})
        row = dict(n=n, D=20, R=2)
        for key, fn in calls.items():
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        fb, fby = bound_ms(*gram_cost(2, n, n, 20, False))
        bb, bby = bound_ms(*gram_cost(2, n, n, 20, True))
        row.update(gram_fwd_bound_ms=fb, gram_fwd_bound_by=fby,
                   gram_bwd_bound_ms=bb, gram_bwd_bound_by=bby,
                   gram_bwd_kernel_us=kernel_us(calls["gram_bwd"], "gram_bwd",
                                                iters))
        us = row["gram_bwd_kernel_us"]
        check(us and all(k in dict(DEVICE_CLASSES)["k4"] for k in us),
              f"K4's trace holds {list(us)}, not its class")
        if n == 544:
            cb, cby = bound_ms(*gram_cost(1, 1, n, 20, False))
            row.update(gram_fwd_column_bound_ms=cb,
                       gram_fwd_column_bound_by=cby)
        rows.append(row)
        log("[timing] " + json.dumps(on_card(row)))
    return rows


# ------------------------------------- slice 3: flash attention K6, kvp K5
FLASH_CASES = [                   # tests/test_kernels_pallas.py:49-56
    (256, 256, 64, True, None, "float32"),
    (256, 256, 64, False, None, "float32"),
    (128, 384, 64, True, None, "float32"),
    (300, 300, 32, True, 128, "float32"),
    (1, 513, 64, True, None, "float32"),
    (128, 128, 64, True, None, "bfloat16"),
    (256, 256, 64, True, 0, "float32"),     # window 0: every key masked
    (128, 384, 64, False, 0, "float32"),    # window 0, not causal
]
FLASH_F32_TOL = 2e-5


def flash_tol(ref):
    """Elementwise limit of K6 against its plain version.  Both keep every
    sum in float32 and round the output to q's dtype once; float32 sums
    in another order differ by far less than FLASH_F32_TOL.  In bfloat16
    the two roundings may then land on neighbouring values, which are one
    ulp apart, at most 2⁻⁷·|ref|."""
    import torch
    if ref.dtype == torch.bfloat16:
        return FLASH_F32_TOL + 2.0 ** -7 * ref.float().abs()
    return FLASH_F32_TOL


def flash_err(out, ref, where=None):
    """(max |Δ|, whether every entry is within flash_tol) over ``where``
    (a mask over the leading dimensions), or over all entries."""
    import torch
    d = (out.float() - ref.float()).abs()
    ok = d <= torch.as_tensor(flash_tol(ref), device=d.device)
    if where is not None:
        d, ok = d[where], ok[where]
    return float(d.max()), bool(ok.all())


def flash_bound_ms(nbytes, ops, rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def decode_inputs(dev, b, sk, nh, kh, hd, dtype, seed, idle=True):
    """One decode step's attention inputs as the serving engine leaves
    them: row r has written positions 0..len_r−1 into slots 0..len_r−1 of
    its cache (ragged lengths), the rest of its slots are empty (−1); the
    trash slot Sk−1 holds an idle row's write (finite values, position
    −1); with ``idle`` the last row is idle (query position −1).  The
    cache values are random everywhere, so a mask that leaked would
    show."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    kv_pos = np.full((b, sk), -1, np.int32)
    q_pos = np.full((b, 1), -1, np.int32)
    for r in range(b - 1 if idle else b):
        n = int(rng.integers(sk // 4, sk - 1))
        kv_pos[r, :n] = np.arange(n)
        q_pos[r, 0] = n - 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(dtype)
               for sh in ((b, 1, nh, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(kv_pos).to(dev))


def serving_step_inputs(dev, seed, nh=24, kh=8, hd=128):
    """The serving path's K6 call in steady decode: 8 slots of a 512-slot
    bf16 cache at positions 64–104 (row r at 64 + 40r/7), each having
    written positions 0..q_pos into slots 0..q_pos, the rest −1; llama3.2-3b's
    heads by default."""
    import torch
    q, k, v, _, _ = decode_inputs(dev, 8, 512, nh, kh, hd, torch.bfloat16,
                                  seed, idle=False)
    q_pos = torch.tensor([[64 + 40 * r // 7] for r in range(8)],
                         dtype=torch.int32, device=dev)
    slots = torch.arange(512, dtype=torch.int32, device=dev)[None]
    kv_pos = torch.where(slots <= q_pos, slots, -1).to(torch.int32)
    return q, k, v, q_pos, kv_pos.contiguous()


def full_cache_inputs(dev, b, sk, nh, kh, hd, dtype, seed):
    """A decode step over a full cache: every slot valid, every row at
    position Sk−1 (the timing shape; every key is read)."""
    import torch
    q, k, v, _, _ = decode_inputs(dev, b, sk, nh, kh, hd, dtype, seed)
    q_pos = torch.full((b, 1), sk - 1, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(sk, dtype=torch.int32,
                          device=dev).expand(b, sk).contiguous()
    return q, k, v, q_pos, kv_pos


def check_flash(tag, inputs, err, causal=True, window=None):
    """K6 against its plain version on the same CUDA tensors; live rows
    within flash_tol, rows with no visible key exactly 0; row independence
    (row 0 alone is bitwise row 0 of the batch)."""
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,
                                               position_mask)
    q, k, v, q_pos, kv_pos = inputs
    out = FK.flash_attention_fwd(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window)
    ref = flash_attention_fwd_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window)
    alone = FK.flash_attention_fwd(*(t[:1].contiguous() for t in inputs),
                                   causal=causal, window=window)
    torch.cuda.synchronize()
    seen = position_mask(q_pos, kv_pos, causal, window).any(-1)  # (B, Sq)
    e, ok = flash_err(out, ref, seen)
    check(ok, f"{tag}: K6 err {e} over its limit")
    check(not bool(out[~seen].any()), f"{tag}: a row with no visible key "
          f"is not 0")
    check(bool(torch.isfinite(out.float()).all()), f"{tag}: K6 not finite")
    check(torch.equal(alone[0], out[0]), f"{tag}: row 0 differs alone")
    err["flash"] = max(err["flash"], e)
    log(f"[kernels] {tag}: K6 |Δ| {e:.3e} (within {FLASH_F32_TOL:g}"
        f"{' + 2^-7·|ref|' if q.dtype == torch.bfloat16 else ''}), "
        f"{int((~seen).sum())} rows with no visible key = 0, row 0 alone "
        f"bitwise")


def phase_flash_kernels(dev, err):
    import numpy as np
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import flash_attention_fwd_ref
    err["flash"] = 0.0
    for sq, sk, h, causal, window, dt in FLASH_CASES:
        rng = np.random.default_rng(sq + sk)
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.standard_normal((s, h)).astype(
            np.float32)).to(dev).to(dtype) for s in (sq, sk, sk))
        out = FK.flash_attention(q, k, v, causal=causal, window=window)
        # the plain version through the same suffix-aligned positions
        qp = torch.arange(sk - sq, sk, dtype=torch.int32, device=dev)[None]
        kp = torch.arange(sk, dtype=torch.int32, device=dev)[None]
        ref = flash_attention_fwd_ref(q[None, :, None], k[None, :, None],
                                      v[None, :, None], qp, kp, causal=causal,
                                      window=window)[0, :, 0]
        torch.cuda.synchronize()
        e, ok = flash_err(out, ref)
        case = (sq, sk, h, causal, window, dt)
        check(ok, f"flash case {case}: err {e} over its limit")
        if causal and window is not None and window <= 0:
            check(not bool(out.any()), f"flash case {case}: window "
                  f"{window} must mask every key (the Pallas rule)")
        err["flash"] = max(err["flash"], e)
    log(f"[kernels] flash_attention on the Pallas test cases: within "
        f"{FLASH_F32_TOL:g} (f32) / {FLASH_F32_TOL:g} + 2^-7·|ref| (bf16)")
    # decode, Sk a multiple of the split length or not
    for sk in (512, 513, 4095, 4096):
        for dt in ("bfloat16", "float32"):
            check_flash(f"decode B=8 NH=24 KH=8 hd=128 Sk={sk} {dt}",
                        decode_inputs(dev, 8, sk, 24, 8, 128,
                                      getattr(torch, dt), seed=sk), err)
    # recurrentgemma-9b's local attention at a decode step: hd=256 (MQA)
    for dt in (torch.bfloat16, torch.float32):
        check_flash(f"decode recurrentgemma-9b B=8 NH=16 KH=1 hd=256 "
                    f"Sk=2048 window 2048 {str(dt)[6:]}",
                    decode_inputs(dev, 8, 2048, 16, 1, 256, dt, seed=256),
                    err, window=2048)
    # split edges (split_len 64 at Sk=512): row 0 sees slots 70..110 only
    # (one split), row 1 slots 0..30, row 2 nothing in any split though
    # its query is live, row 3 ends mid-split; with a window of 16 too
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, q_pos, kv_pos = decode_inputs(dev, 8, 512, 24, 8, 128, dt,
                                               seed=21)
        kv_pos[:4] = -1
        kv_pos[0, 70:111] = torch.arange(41, dtype=torch.int32)
        kv_pos[1, :31] = torch.arange(31, dtype=torch.int32)
        kv_pos[3, :300] = torch.arange(300, dtype=torch.int32)
        q_pos[:4, 0] = torch.tensor([40, 30, 100, 299], dtype=torch.int32)
        for window in (None, 16):
            check_flash(f"split edges {str(dt)[6:]} window {window}",
                        (q, k, v, q_pos, kv_pos), err, window=window)
    # bf16 rows around the MMA threshold (Sq·G = 64), a chunk continuing
    # a cache of 40 positions; the path must be the one plan() names
    for hd in (64, 128):
        for sq, nh, kh in ((63, 2, 2), (64, 2, 2), (65, 2, 2), (21, 6, 2),
                           (22, 6, 2)):
            g = torch.Generator(device=dev).manual_seed(sq * hd + nh)
            sk = 40 + sq
            q, k, v = (torch.randn(sh, generator=g, device=dev).to(
                torch.bfloat16) for sh in ((2, sq, nh, hd), (2, sk, kh, hd),
                                           (2, sk, kh, hd)))
            q_pos = (40 + torch.arange(sq, dtype=torch.int32,
                                       device=dev)).expand(2, sq).contiguous()
            kv_pos = torch.arange(sk, dtype=torch.int32,
                                  device=dev).expand(2, sk).contiguous()
            path = FK.plan(torch.bfloat16, sq, nh, kh, hd, sk)[0]
            check(path == ("mma" if sq * nh // kh >= 64 else "split"),
                  f"plan picks {path} at Sq·G = {sq * nh // kh}")
            check_flash(f"bf16 Sq·G={sq * nh // kh} (G={nh // kh}) hd={hd} "
                        f"{path}", (q, k, v, q_pos, kv_pos), err)
    # a windowed bf16 chunk on the MMA path (192 rows, window 24)
    g = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((2, 96, 4, 128), (2, 160, 2, 128), (2, 160, 2, 128)))
    q_pos = (40 + torch.arange(96, dtype=torch.int32, device=dev)).expand(
        2, 96).contiguous()
    kv_pos = torch.arange(160, dtype=torch.int32, device=dev).expand(
        2, 160).contiguous()
    check_flash("prefill chunk Sq=96 G=2 over a cache, window 24, bf16 mma",
                (q, k, v, q_pos, kv_pos), err, window=24)
    # local window and a chunk of queries continuing a cache, reduced widths
    q, k, v, _, kv_pos = decode_inputs(dev, 4, 256, 4, 2, 32, torch.float32,
                                       seed=9, idle=False)
    q_pos = torch.stack([torch.arange(40, 56, dtype=torch.int32, device=dev)]
                        * 4)
    qc = torch.randn((4, 16, 4, 32), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(10))
    check_flash("prefill chunk Sq=16 over a cache, window 24",
                (qc, k, v, q_pos, kv_pos), err, window=24)
    # causal prefill: the causal tile skip and hd=128; bf16 on the MMA path
    # f32: one split of the whole cache, two spans of positions at S=2048
    for s_len, dt in ((512, torch.float32), (2048, torch.float32),
                      (2048, torch.bfloat16)):
        path, split_len = FK.plan(dt, s_len, 24, 24, 128, s_len)
        check((path, FK.n_splits(s_len, split_len))
              == (("mma", 1) if dt == torch.bfloat16 else ("split", 1)),
              f"causal prefill S={s_len} {dt}: unexpected plan")
        g = torch.Generator(device=dev).manual_seed(2)
        qb, kb, vb = (torch.randn((1, 24, s_len, 128), generator=g,
                                  device=dev).to(dt) for _ in range(3))
        out = FK.flash_attention_bhsd(qb, kb, vb, causal=True)
        pos = torch.arange(s_len, dtype=torch.int32, device=dev)[None]
        ref = flash_attention_fwd_ref(qb.transpose(1, 2), kb.transpose(1, 2),
                                      vb.transpose(1, 2), pos,
                                      pos).transpose(1, 2)
        torch.cuda.synchronize()
        e, ok = flash_err(out, ref)
        tag = f"causal prefill S={s_len} H=24 {str(dt)[6:]}"
        check(ok, f"{tag}: err {e} over its limit")
        err["flash"] = max(err["flash"], e)
        log(f"[kernels] {tag} hd=128 via flash_attention_bhsd: |Δ| {e:.3e}")


def kvp_inputs(q, n, d, dev, far=0, seed=0):
    """K5's inputs from the seed; past D = 40 the lengthscales grow with
    √D, as a fitted GP's do, so that k is not 0 almost everywhere."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + q + n)
    xq = rng.uniform(0, 1, (q, d))
    xt = rng.uniform(0, 1, (n, d))
    al = rng.standard_normal(n)
    if far:
        xt[-far:] = 1e6 + np.arange(far)[:, None]
        al[-far:] = 0.0
    ils = np.exp(rng.uniform(-1.0, 2.0, d))
    if d > 40:
        ils *= math.sqrt(20 / d)
    return tuple(torch.tensor(a, device=dev)
                 for a in (xq, xt, al, ils, np.float64(1.7)))


def check_kvp(tag, inputs, err):
    """K5 against its plain version: each row within 1e-12 of its
    Σ_j |k_ij α_j|; bitwise K1's mean (its kinv plays no part in the mean:
    the identity); the rows of the first 1, 10 and 17 queries alone
    bitwise those of the batch (K5's geometry changes past q = 16)."""
    import torch
    from repro_torch.kernels.kvp import kernel as VK
    from repro_torch.kernels.kvp.ref import kvp_ref
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.kernels.matern.ref import matern52_gram_ref
    xq, xt, al, ils, amp = inputs
    out = VK.kvp_fwd(xq, xt, al, ils, amp)
    ref = kvp_ref(xq, xt, al, ils, amp)
    parts = {m: VK.kvp_fwd(xq[:m].contiguous(), xt, al, ils, amp)
             for m in (1, 10, 17) if m < xq.shape[0]}
    eye = torch.eye(xt.shape[0], dtype=torch.float64, device=xq.device)
    k1 = K.matern52_posterior_fwd(xq, xt, al, eye, ils, amp)[0]
    torch.cuda.synchronize()
    scale = matern52_gram_ref(xq, xt, ils, amp).abs() @ al.abs()
    e = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{tag}: K5 not finite")
    check(bool((e <= 1e-12 * scale).all()), f"{tag}: K5 err "
          f"{float(e.max())} over 1e-12·Σ|terms|")
    check(torch.equal(out, k1), f"{tag}: K5 is not K1's mean bitwise "
          f"(max |Δ| {float((out - k1).abs().max())})")
    for m, part in parts.items():
        check(torch.equal(part, out[:m]), f"{tag}: K5's first {m} rows "
              f"differ alone")
    err["kvp"] = max(err["kvp"], float(e.max()))
    return float(e.max())


def phase_kvp_kernels(dev, err):
    """K5 at the Pallas test shapes, the kvp path's and the timing shapes
    (each with _FAR rows from n = 544 on), and D = 300 and 1000."""
    from repro_torch.kernels.kvp import kernel as VK
    err["kvp"] = 0.0
    geometries = set()
    for q, n, d in ((10, 50, 5), (128, 256, 16), (77, 500, 40), (1, 130, 8),
                    (10, 544, 20), (1000, 2048, 20), (10, 544, 300),
                    (40, 544, 1000)):
        far = 32 if n >= 544 else 0
        geometries.add(VK.kvp_plan(q, n, d).rows)
        check_kvp(f"kvp q={q} n={n} D={d}", kvp_inputs(q, n, d, dev, far),
                  err)
    check(geometries == {VK.FEW, VK.MANY}, f"K5 ran only {geometries}")
    log(f"[kernels] kvp at the Pallas test shapes, (10, 544, 20), "
        f"(1000, 2048, 20), D = 300 and 1000: max |Δ| {err['kvp']:.3e} "
        f"(≤1e-12·Σ|terms|), K1's mean bitwise, rows at q = 1, 10, 17 "
        f"bitwise")


def phase_kvp_path(s, err):
    """The kvp path: ``gp_mean_kvp`` (backend "auto") for the posterior
    mean of the fused ask's fitted GP at a restart batch (q = B = 10),
    after the ask phase; K5 launches counted around it alone, the result
    held against the plain version."""
    import torch
    from repro_torch.kernels.kvp import kernel as VK
    from repro_torch.kernels.kvp.ops import gp_mean_kvp
    gp = s._ask.gp_state()
    n = s._ask.n_obs
    xt, alpha = gp.x_train.contiguous(), gp.alpha.contiguous()
    ils = torch.exp(-gp.params.log_lengthscale).contiguous()
    amp = gp.params.amplitude.contiguous()
    g = torch.Generator(device="cpu").manual_seed(n)
    xq = torch.rand((10, xt.shape[1]), generator=g,
                    dtype=torch.float64).to(xt.device)
    VK.reset_launch_counts()
    mean = gp_mean_kvp(xq, xt, alpha, ils, amp, backend="auto")
    launches = VK.launch_counts()["kvp_fwd"]
    check(launches == 1, f"kvp path: {launches} K5 launches")
    e = check_kvp(f"kvp path n={n} bucket {xt.shape[0]}",
                  (xq, xt, alpha, ils, amp), err)
    log(f"[kvp] gp_mean_kvp on the ask state (n={n}, bucket "
        f"{xt.shape[0]}, q=10): K5 launches {launches}, |Δ| {e:.3e}, "
        f"mean in [{float(mean.min()):.3f}, {float(mean.max()):.3f}]")
    return launches


# ---------------------------------------------------- slice 3: LM serving
SERVE_ARCH = "llama3.2-3b"
SERVE_SEED = 0


GEMM_KEYS = ("gemm", "xmma", "cutlass", "nvjet", "sm90")


def serve_device_us(prof):
    """Device µs of one trace: K6, the matrix products (cuBLAS kernels, by
    name) and everything."""
    k6 = gemm = busy = 0.0
    for ev in prof.key_averages():
        us = _device_us(ev)
        busy += us
        if "flash_fwd" in ev.key:      # split, merge and MMA kernels
            k6 += us
        elif any(k in ev.key.lower() for k in GEMM_KEYS):
            gemm += us
    return k6, gemm, busy


def serve_requests(rng, vocab, n, lo, hi, new):
    import numpy as np
    from repro_torch.serve.engine import Request
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(
        rng.integers(lo, hi + 1))).astype(np.int32), max_new_tokens=new)
        for i in range(n)]


def solo_and_shared(params, cfg, slots, max_len, lens=(40, 23)):
    """Staggered admission and chunked prefill decode bitwise what each
    request decodes alone (prompts of ``lens`` tokens, 12 new), with the
    same slot count.  (Not for the hybrid family, where the reference
    lacks the property: ROADMAP C17.)"""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(SERVE_SEED + 1)
    pa = rng.integers(0, cfg.vocab_size, lens[0]).astype(np.int32)
    pb = rng.integers(0, cfg.vocab_size, lens[1]).astype(np.int32)
    solo = {}
    for uid, prompt in ((0, pa), (1, pb)):
        e = ServeEngine(params, cfg, slots=slots, max_len=max_len)
        e.submit(Request(uid=uid, prompt=prompt, max_new_tokens=12))
        solo[uid] = e.run_until_drained()[0].out_tokens
    e = ServeEngine(params, cfg, slots=slots, max_len=max_len)
    e.submit(Request(uid=0, prompt=pa, max_new_tokens=12))
    for _ in range(3):
        e.step()
    e.submit(Request(uid=1, prompt=pb, max_new_tokens=12))
    stag = {r.uid: r.out_tokens for r in e.run_until_drained()}
    check(stag == solo, f"{cfg.name}: staggered admission differs from "
          f"solo: {stag} vs {solo}")
    e = ServeEngine(params, cfg, slots=slots, max_len=max_len,
                    prefill_chunk=4)
    e.submit(Request(uid=0, prompt=pa, max_new_tokens=12))
    e.step()
    check(e._prefilling == {0} and e.positions[0] == 4,
          "chunked prefill did not stop after 4 steps")
    e.submit(Request(uid=1, prompt=pb, max_new_tokens=12))
    chunk = {r.uid: r.out_tokens for r in e.run_until_drained()}
    check(chunk == solo, f"{cfg.name}: chunked prefill differs from solo: "
          f"{chunk} vs {solo}")
    check(e.stats["compiles"] == 1, "chunked engine: more than one program")
    log(f"[serve] {cfg.name}: staggered admission and chunked prefill "
        f"(chunk 4) decode "
        f"bitwise what each request decodes alone ({slots} slots; prompts "
        f"{lens[0]} and {lens[1]} tokens, 12 new)")


class RouterSpy:
    """Records each MoE call's router probabilities (the port's
    ``moe._route``); with ``pin`` (a forward's recorded calls, its
    sequence length and layer count), a decode step's tokens take the
    experts that forward chose for them, gated by the decode's own
    probabilities: decode and forward then differ by rounding alone."""

    def __init__(self, pin=None):
        self.calls, self.pin = [], pin

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MOE
        self._mod, self._inner = MOE, MOE._route

        def spy(x_flat, router_w, k):
            probs, gates, idx = self._inner(x_flat, router_w, k)
            if self.pin is not None:
                fwd, s, n = self.pin
                step, layer = divmod(len(self.calls), n)
                rows = torch.arange(x_flat.shape[0],
                                    device=x_flat.device) * s + step
                idx = torch.topk(fwd[layer][rows], k).indices
                gates = torch.gather(probs, 1, idx)
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            self.calls.append(probs)
            return probs, gates, idx
        MOE._route = spy
        return self

    def __exit__(self, *exc):
        self._mod._route = self._inner


def routing_flips(fwd, dec, k):
    """{token: (gap, drift, layer)} for every token whose top-k set
    differs between two runs' (tokens, E) router probabilities a layer,
    at the first layer where it does: the forward's gap p_k − p_(k+1)
    there and the token's largest |Δp| between the runs."""
    import torch
    flips = {}
    for layer, (a, b) in enumerate(zip(fwd, dec)):
        top_a = torch.sort(torch.topk(a, k).indices, 1).values
        top_b = torch.sort(torch.topk(b, k).indices, 1).values
        for t in torch.nonzero((top_a != top_b).any(1))[:, 0].tolist():
            if t not in flips:
                srt = torch.sort(a[t], descending=True).values
                flips[t] = (float(srt[k - 1] - srt[k]),
                            float((a[t] - b[t]).abs().max()), layer)
    return flips


def decode_vs_forward(params, cfg, dev, s=64):
    """Step-by-step decode logits against teacher-forced forward logits
    over ``s`` tokens, two rows, at full width in bf16, within 5e-2 of
    max|logit|; and the greedy choices of the two.  With experts, bf16
    rounding (the prefill's and a decode step's products differ) flips a
    router's choice wherever two experts lie closer than that rounding,
    and over many layers most tokens meet one: every such flip must be a
    near tie (the forward's gap p_k − p_(k+1) at most twice the token's
    |Δp| between the runs), and the 5e-2 holds for a second decode whose
    tokens take the forward's experts (``RouterSpy(pin=...)``).  →
    (rel, greedy agreement, the checked rel, flips)."""
    import contextlib
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (2, s), generator=g, device=dev)
    moe = cfg.is_moe

    def decode(spy):
        cache = lm.init_cache(cfg, 2, s, device=dev)
        outs = []
        with spy or contextlib.nullcontext():
            for i in range(s):
                lg, cache = lm.decode_step(
                    params, cfg, toks[:, i:i + 1], cache,
                    torch.full((2,), i, dtype=torch.int32, device=dev))
                outs.append(lg.float())
        return torch.stack(outs, 1)

    spy_f, spy_d = (RouterSpy(), RouterSpy()) if moe else (None, None)
    with torch.no_grad():
        with spy_f or contextlib.nullcontext():
            hid, _ = lm.forward(params, cfg, toks)
        ref = L.lm_logits(params["embed"], cfg, hid).float()
        dec = decode(spy_d)
        pinned = decode(RouterSpy(pin=(spy_f.calls, s, cfg.n_layers))) \
            if moe else dec
    scale = ref.abs().max()
    rel = float((dec - ref).abs().max() / scale)
    held = float((pinned - ref).abs().max() / scale)
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    check(bool(torch.isfinite(dec).all() and torch.isfinite(pinned).all()),
          "decode logits not finite")
    flips = {}
    if moe:
        n = cfg.n_layers
        # decode calls: step-major, layer-minor, (2, E) each → (2·s, E)
        # a layer, in the forward's token order b·s + i
        per_layer = [torch.stack(spy_d.calls[li::n], 1).reshape(2 * s, -1)
                     for li in range(n)]
        flips = routing_flips(spy_f.calls, per_layer,
                              cfg.experts_per_token)
        ratio = max((gap / drift for gap, drift, _ in flips.values()),
                    default=0.0)
        log(f"[serve] {cfg.name}: {len(flips)} of {2 * s} tokens flip a "
            f"routing choice between forward and decode (first flip "
            f"layers {sorted(f[2] for f in flips.values())}); largest "
            f"gap / drift {ratio:.3f} (a near tie: ≤ 2)")
        for t, (gap, drift, layer) in flips.items():
            check(gap <= 2 * drift, f"{cfg.name}: token {t} flipped at "
                  f"layer {layer} at a gap {gap} > 2 × drift {drift}: not "
                  f"a near tie")
    log(f"[serve] {cfg.name}: decode vs forward logits over {s} tokens "
        f"(bf16, full width): max |Δ| / max |logit| {rel:.3e}"
        + (f", {held:.3e} with the forward's experts pinned" if moe else "")
        + f" (≤5e-2); greedy agree {agree:.3f}")
    check(held <= 5e-2, f"{cfg.name}: decode vs forward logits: rel {held} "
          f"> 5e-2")
    return rel, agree, held, len(flips)


def to_device(node, d):
    """A parameter tree (dicts and lists of tensors) on device ``d``."""
    if isinstance(node, dict):
        return {k: to_device(v, d) for k, v in node.items()}
    if isinstance(node, list):
        return [to_device(v, d) for v in node]
    return node.to(d)


def card_vs_cpu(dev, arch=SERVE_ARCH, lens=(4, 12), new=6, max_len=64):
    """The port on the card against the port on the CPU, ``arch``'s
    reduced config in f32 (TF32 off): forward logits within 1e-5 of
    max|logit|, and a ServeEngine's greedy tokens equal (7 requests of
    ``lens`` prompt tokens and ``new`` new ones, 3 slots), with K6
    launched once per attention layer a step on the card (never for
    ssm)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch).reduced().replace(dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SERVE_SEED))
    card = to_device(cpu, dev)
    # ssm: two whole mLSTM chunks of 32 (the reference pads none)
    s = 64 if cfg.family == "ssm" else 48
    toks = torch.randint(0, cfg.vocab_size, (2, s),
                         generator=torch.Generator().manual_seed(7))
    out = {}
    for name, p, d in (("cpu", cpu, "cpu"), ("cuda", card, dev)):
        with torch.no_grad():
            hid, _ = lm.forward(p, cfg, toks.to(d))
            out[name] = L.lm_logits(p["embed"], cfg, hid).cpu()
    rel = float((out["cuda"] - out["cpu"]).abs().max()
                / out["cpu"].abs().max())
    check(rel <= 1e-5, f"{arch}: card vs CPU forward logits: rel {rel} > "
          f"1e-5")
    tokens, top = {}, 0
    for name, p in (("cpu", cpu), ("cuda", card)):
        e = ServeEngine(p, cfg, slots=3, max_len=max_len)
        for r in serve_requests(np.random.default_rng(3), cfg.vocab_size, 7,
                                *lens, new):
            e.submit(r)
        before = FK.LAUNCHES["flash_attention_fwd"]
        tokens[name] = {r.uid: r.out_tokens for r in e.run_until_drained()}
        launched = FK.LAUNCHES["flash_attention_fwd"] - before
        want = lm.attention_layers(cfg) * e.stats["steps"] \
            if name == "cuda" else 0
        check(launched == want == e.stats["flash_launches"],
              f"reduced {arch} engine on {name}: {launched} K6 launches, "
              f"want {want}")
        top = max(top, int(e.positions.max()))
    check(tokens["cuda"] == tokens["cpu"], f"{arch}: card and CPU engines "
          f"decode different tokens")
    if cfg.window:
        check(top > cfg.window, f"{arch}: the ring never wrapped")
    log(f"[serve] card vs CPU, reduced {arch} f32: forward logits rel "
        f"{rel:.3e} (≤1e-5); ServeEngine greedy tokens equal (7 requests, "
        f"3 slots, prompts {lens[0]}-{lens[1]}, {new} new, last position "
        f"{top}" + (f", window {cfg.window}" if cfg.window else "") + ")")
    return rel


def serve_traffic(params, cfg, slots, max_len, tag):
    """16 requests (prompts of 16–128 tokens, 32 new tokens each) through
    a ServeEngine, the queue refilling slots as requests finish: every
    request decodes 32 tokens inside the vocabulary, K6 launches = the
    attention layers × steps, one program.  → (engine, row, K6
    launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, slots=slots, max_len=max_len)
    reqs = serve_requests(np.random.default_rng(SERVE_SEED), cfg.vocab_size,
                          16, 16, 128, 32)
    for r in reqs:
        eng.submit(r)
    n_attn = lm.attention_layers(cfg)
    FK.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FK.launch_counts()["flash_attention_fwd"]
    st = dict(eng.stats)
    check(len(done) == 16 and all(len(r.out_tokens) == 32 for r in done),
          f"{tag}: not every request decoded 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
          f"{tag}: a token id out of the vocabulary")
    check(launches == n_attn * st["steps"] == st["flash_launches"],
          f"{tag}: K6 launches {launches} != {n_attn} × {st['steps']} steps")
    check(st["compiles"] == 1, f"{tag}: {st['compiles']} decode programs")
    row = dict(arch=cfg.name, slots=slots, max_len=max_len, requests=16,
               prompt_lens=[len(r.prompt) for r in reqs],
               steps=st["steps"], tokens=st["tokens"], wall_s=wall,
               tokens_per_s=st["tokens"] / wall,
               ms_per_step=wall / st["steps"] * 1e3,
               param_gb=lm.param_bytes(params) / 1e9,
               cache_mb=st["cache_bytes"] / 1e6, attention_layers=n_attn,
               k6_launches=launches, compiles=st["compiles"])
    return eng, row, launches


def steady_decode(eng, cfg, tag):
    """Device time of steady decode steps: 8 slots decoding (prompts of
    64 tokens), 20 steps traced and 20 more untraced: K6, matrix-product,
    other (elementwise) and busy device ms a step, host ms a step, the
    idle share."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    tokens0 = eng.stats["tokens"]
    for r in serve_requests(np.random.default_rng(SERVE_SEED + 3),
                            cfg.vocab_size, 8, 64, 64, 200):
        eng.submit(r)
    while eng._prefilling or eng.queue or not eng.stats["tokens"] > tokens0:
        eng.step()
    steps0 = eng.stats["steps"]
    with card_trace() as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    n = eng.stats["steps"] - steps0
    k6_us, gemm_us, busy_us = serve_device_us(prof)
    attn = lm.attention_layers(cfg) > 0
    check(busy_us > 0 and (k6_us > 0) == attn, f"{tag}: profiler saw "
          f"{k6_us} µs of K6 device time ({'some' if attn else 'none'} "
          f"expected) and {busy_us} µs busy")
    t0 = time.perf_counter()
    for _ in range(20):
        eng.step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    return dict(steps=n, k6_device_ms_per_step=k6_us / 1e3 / n,
                gemm_device_ms_per_step=gemm_us / 1e3 / n,
                other_device_ms_per_step=(busy_us - k6_us - gemm_us) / 1e3
                / n,
                device_busy_ms_per_step=busy_us / 1e3 / n,
                traced_ms_per_step=traced_ms / n,
                untraced_ms_per_step=untraced_ms / 20,
                idle_share_est=max(0.0, 1.0 - busy_us / 1e3 / untraced_ms
                                   * 20 / n),
                positions=[int(p) for p in eng.positions])


def phase_serve(dev):
    """ServeEngine on llama3.2-3b at full width (bf16, 28 layers, weights
    drawn on the card from the seed), 8 slots, max_len 512: 16 requests,
    prompts of 16–128 tokens, 32 new tokens each, the queue refilling
    slots as requests finish.  K6 launches = 28 × steps, one program."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import param_counts

    cfg = get_config(SERVE_ARCH)
    slots, max_len = 8, 512
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_numel(params)
    want = param_counts(cfg)["total"] + (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params == want, f"{n_params} parameters, want {want}")
    eng, row, launches = serve_traffic(params, cfg, slots, max_len, "serve")
    row.update(n_params=n_params, init_s=init_s)
    log("[serve] " + json.dumps(on_card(row)))
    brk = steady_decode(eng, cfg, "serve")
    log("[serve] steady decode, 8 slots at positions ~64-104: "
        + json.dumps(on_card(brk)))
    row.update(steady=brk)
    del eng
    solo_and_shared(params, cfg, slots, max_len)
    row["decode_vs_forward_rel"], row["decode_vs_forward_greedy_agree"] = \
        decode_vs_forward(params, cfg, dev)[:2]
    del params
    torch.cuda.empty_cache()
    row["card_vs_cpu_rel"] = card_vs_cpu(dev)
    return row, launches


# ------------------------------- slice 7: the moe, vlm and hybrid families
# (arch, layers kept (None: all), capacity factor of the bitwise
# staggered/chunked-equals-solo check (None: published; "skip": the
# reference lacks the property, ROADMAP C17), card-vs-CPU traffic:
# (prompt lengths, new tokens, max_len); hybrid wraps its reduced window
# of 64).  Slice 8 adds the ssm family (xlstm-1.3b).  Slice 9 cuts the
# depth of qwen3 (48 → 8 layers), recurrentgemma (38 → 8: two triples and
# a recurrent tail of 2) and xlstm (48 → 16: two groups) to keep the
# script's time within the run's limit on a slow host (1,352.6 s, chip run
# 2 of PR 25): every block kind and every check stays, at full width
FAMILIES = (
    ("qwen3-moe-30b-a3b", 8, 100.0, ((4, 12), 6, 64)),
    ("chameleon-34b", 4, None, ((4, 12), 6, 64)),
    ("recurrentgemma-9b", 8, "skip", ((40, 60), 40, 128)),
    ("xlstm-1.3b", 16, "skip", ((4, 12), 6, 64)),
    # slice 11: the dense configs no earlier phase held, 8 layers each
    # (of 28, 40 and 30) so the three take ~45 s within the script's
    # time: partial rotary, layernorm with bias and an ungated GELU MLP,
    # full MHA (32 KV heads)
    ("chatglm3-6b", 8, None, ((4, 12), 6, 64)),
    ("starcoder2-15b", 8, None, ((4, 12), 6, 64)),
    ("deepseek-7b", 8, None, ((4, 12), 6, 64)),
)


def expected_params(cfg):
    """Parameters the port draws for ``cfg``: ``param_counts`` plus what
    it leaves out: the norm scales (and layernorm biases), qk-norm
    scales, and for hybrid the RG-LRU gate matrices (2·W² − W a recurrent
    layer beyond its 3·W) and GeGLU's gate projection (d·ff a layer).
    For ssm ``param_counts`` counts every layer as an mLSTM block whose
    q/k/v take 3·up/2 columns (up = 2·d; xlstm-1.3b: 2,621,964,288); the
    model has slstm_every − 1 mLSTM blocks a group (up- and gate
    projections, conv, q and k of H·dk = up/2 columns each, v the
    up-projection itself, the f32 gates, skip scales, down-projection)
    and one sLSTM block (4d² in, four H·(d/H)² f32 recurrent matrices, d²
    out), plus the embedding, the head and the final layernorm."""
    from repro_torch.models import lm
    from repro_torch.models.config import param_counts
    d, n = cfg.d_model, cfg.n_layers
    if cfg.family == "ssm":
        n_groups, n_m = lm.ssm_layout(cfg)
        up, heads = 2 * d, cfg.n_heads
        mlstm = (3 * d * up + up * up + cfg.conv_width * up + 2 * heads * up
                 + 2 * up)
        slstm = 5 * d * d + 4 * d * d // heads
        return (2 * cfg.vocab_size * d + 2 * d
                + n_groups * (n_m * mlstm + slstm))
    want = param_counts(cfg)["total"] \
        + (2 * n + 1) * d * (2 if cfg.norm == "layernorm" else 1)
    if cfg.qk_norm:
        want += 2 * cfg.head_dim * n
    if cfg.family == "hybrid":
        n_rec, w = n - lm.hybrid_layout(cfg)[0], cfg.lru_width
        want += n_rec * (2 * w * w - w)
        if cfg.activation == "geglu":
            want += n * d * cfg.d_ff
    return want


def ssm_cache_bytes(cfg, slots):
    """Bytes of an ssm decode cache: per mLSTM layer and slot the conv
    state (K−1, up) in the model dtype and C (H, dk, dv), n (H, dk), m (H)
    in float32; per sLSTM layer and slot c, n, h, m (d) in float32."""
    from repro_torch.models import lm
    from repro_torch.models.xlstm import mlstm_dims
    n_groups, n_m = lm.ssm_layout(cfg)
    up, dk, dv = mlstm_dims(cfg)
    h, es = cfg.n_heads, lm.torch_dtype(cfg).itemsize
    mlstm = (cfg.conv_width - 1) * up * es + 4 * h * (dk * dv + dk + 1)
    return slots * n_groups * (n_m * mlstm + 16 * cfg.d_model)


def step_weight_bytes(params, cfg, slots):
    """Weight bytes a decode step reads: every parameter but the token
    table, of which it reads the slots' rows.  Every expert counts: the
    reference's formulation runs all E experts each step."""
    from repro_torch.models import lm
    tok = params["embed"]["tok"]
    return (lm.param_bytes(params) - tok.numel() * tok.element_size()
            + slots * cfg.d_model * tok.element_size())


def phase_serve_families(dev, families=FAMILIES):
    """ServeEngine on qwen3-moe-30b-a3b, chameleon-34b's backbone,
    recurrentgemma-9b and xlstm-1.3b at full width (depth as FAMILIES
    keeps it), bf16, weights drawn on the card
    from the seed, each with phase_serve's traffic: K6 launches =
    attention layers × steps (none for ssm), one program; tokens/s, ms a
    step and steady decode's device ms (K6, products, other, busy) and
    idle share beside the step's bound (its weight bytes, and for ssm the
    states read and written, over the HBM rate); decode vs forward logits
    (qwen3 at capacity factor 100); staggered and chunked prefill bitwise
    solo where the reference has that property; the card against the CPU
    on each reduced config.  → ({arch: row}, {arch: K6 launches})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    rows, launches = {}, {}
    for arch, layers, solo_cf, cpu_traffic in families:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        slots, max_len = 8, 512
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SERVE_SEED))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        peak_init = torch.cuda.max_memory_allocated()
        n_params = lm.param_numel(params)
        want = expected_params(cfg)
        check(n_params == want, f"{arch}: {n_params} parameters, want {want}")
        eng, row, launches[arch] = serve_traffic(params, cfg, slots, max_len,
                                                 arch)
        wbytes = step_weight_bytes(params, cfg, slots)
        sbytes = 0
        if cfg.family == "ssm":
            # every state byte is read and written once a step
            sbytes = 2 * eng.stats["cache_bytes"]
            want = ssm_cache_bytes(cfg, slots)
            check(eng.stats["cache_bytes"] == want, f"{arch}: cache "
                  f"{eng.stats['cache_bytes']} bytes, want {want}")
        row.update(n_params=n_params, init_s=init_s,
                   init_peak_gb=peak_init / 1e9,
                   layers_cut_from=None if layers is None
                   else get_config(arch).n_layers,
                   step_weight_gb=wbytes / 1e9, step_state_gb=sbytes / 1e9,
                   step_bound_ms=(wbytes + sbytes) / HBM_BYTES_PER_S * 1e3)
        log(f"[families] {arch}: " + json.dumps(on_card(row)))
        brk = steady_decode(eng, cfg, arch)
        brk["step_bound_ms"] = row["step_bound_ms"]
        log(f"[families] {arch} steady decode, 8 slots at positions "
            f"~64-104: " + json.dumps(on_card(brk)))
        row.update(steady=brk)
        del eng
        dcfg = cfg.replace(moe_capacity_factor=100.0) if cfg.is_moe else cfg
        (row["decode_vs_forward_rel"], row["decode_vs_forward_greedy_agree"],
         row["decode_vs_forward_held_rel"], row["routing_flips"]) = \
            decode_vs_forward(params, dcfg, dev)
        if solo_cf == "skip":
            log(f"[families] {arch}: staggered admission is not checked "
                f"against solo runs: in the reference an idle row's token "
                f"advances a live slot's recurrent state (ROADMAP C17)")
        else:
            scfg = cfg if solo_cf is None else cfg.replace(
                moe_capacity_factor=solo_cf)
            solo_and_shared(params, scfg, slots, max_len, lens=(24, 13))
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params
        torch.cuda.empty_cache()
        lens, new, cpu_len = cpu_traffic
        row["card_vs_cpu_rel"] = card_vs_cpu(dev, arch, lens, new, cpu_len)
        row["phase_s"] = time.perf_counter() - t_phase
        log(f"[families] {arch}: {row['phase_s']:.1f} s, peak "
            f"{row['peak_gb']:.1f} GB allocated")
        rows[arch] = row
    return rows, launches


def phase_families_timing(dev):
    """K6 at the serving-step shapes of qwen3-moe-30b-a3b (8 slots, NH=32,
    KH=4, hd=128) and recurrentgemma-9b (NH=16, KH=1, hd=256, window
    2048), positions 64–104 of a 512-slot bf16 cache: device and call ms,
    its plain version, SDPA (boolean mask, enable_gqa; timed only) and
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,
                                               position_mask)
    rows = {}
    for arch, nh, kh, hd, window in (("qwen3-moe-30b-a3b", 32, 4, 128, None),
                                     ("recurrentgemma-9b", 16, 1, 256, 2048)):
        q, k, v, qp, kp = serving_step_inputs(dev, 64, nh, kh, hd)
        mask = position_mask(qp, kp, True, window)[:, None]
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        calls = {
            "flash": lambda: FK.flash_attention_fwd(q, k, v, qp, kp,
                                                    window=window),
            "flash_plain": lambda: flash_attention_fwd_ref(q, k, v, qp, kp,
                                                           window=window),
            "flash_sdpa": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)}
        row = dict(shape=f"{arch} serving step B=8 Sk=512 NH={nh} KH={kh} "
                   f"hd={hd} window={window} positions 64-104")
        for key, fn in calls.items():
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, 50)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, 50)
        row["flash_bound_ms"], row["flash_bound_by"] = flash_bound_ms(
            *flash_cost(q, k, qp, kp, window=window))
        row["flash_kernels"] = flash_kernels(calls["flash"])
        check(row["flash_kernels"] == ["flash_fwd_merge_kernel",
                                       "flash_fwd_split_kernel"],
              f"{row['shape']}: K6 ran {row['flash_kernels']}")
        ref = flash_attention_fwd_ref(q, k, v, qp, kp, window=window)
        e, ok = flash_err(calls["flash"](), ref)
        check(ok, f"{row['shape']}: K6 off its plain version by {e}")
        row["max_abs_err"] = e
        rows[arch] = row
        log("[timing] " + json.dumps(on_card(row)))
    return rows


# ------------------------------ slice 8: whisper-base's encoder-decoder
# 8 clips of 1500 stub frame embeddings, a 448-slot decoder cache, 4
# prompt tokens fed one a step, then greedy tokens until 64 are chosen;
# 20 more steps traced and 20 untraced
WHISPER = dict(arch="whisper-base", clips=8, frames=1500, max_len=448,
               prompt=4, new=64, window=20)


def whisper_expected_params(cfg):
    """``param_counts`` plus the layernorm scales and biases it leaves
    out: two a encoder layer, three a decoder layer, the encoder's and
    the decoder's final norms."""
    from repro_torch.models.config import param_counts
    return param_counts(cfg)["total"] + (
        2 * cfg.n_enc_layers + 3 * cfg.n_dec_layers + 2) * 2 * cfg.d_model


def whisper_decode(params, cfg, enc, prompt, new, max_len):
    """``prompt`` (B, P) fed one token a step through ``decode_step``,
    then each step's greedy token (argmax on the card) until ``new`` are
    chosen: P + new − 1 steps.  → (fed tokens (B, steps), step logits
    (B, steps, V) f32, chosen (B, new), cache)."""
    import torch
    from repro_torch.models import whisper as WH
    n_prompt = prompt.shape[1]
    cache = WH.init_cache(params, cfg, enc, prompt.shape[0], max_len,
                          device=enc.device)
    tok, fed, logits, chosen = prompt[:, :1], [], [], []
    for i in range(n_prompt + new - 1):
        fed.append(tok)
        lg, cache = WH.decode_step(params, cfg, tok, cache, i)
        logits.append(lg.float())
        if i + 1 < n_prompt:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = lg.argmax(-1, keepdim=True)
            chosen.append(tok)
    return (torch.cat(fed, 1), torch.stack(logits, 1), torch.cat(chosen, 1),
            cache)


def whisper_step_bytes(params, cache, pos):
    """Bytes a decode step must move: the decoder's weights, its final
    norm and head, the slots' token rows, every layer's cross K/V, and
    the self K/V and positions of the ``pos`` + 1 written slots."""
    from repro_torch.models import lm
    emb, sc = params["embed"], cache["self"]
    b = sc["k"].shape[1]
    self_bytes = sum(t[:, :, :pos + 1].numel() * t.element_size()
                     for t in (sc["k"], sc["v"], sc["pos"]))
    return (lm.param_bytes(params["dec"]) + lm.param_bytes(
        params["final_norm"]) + lm.param_bytes(emb["head"])
        + b * emb["tok"].shape[1] * emb["tok"].element_size()
        + lm.cache_bytes(cache["cross"]) + self_bytes)


def whisper_card_vs_cpu(dev, clips=3, frames=100, new=12):
    """The reduced whisper-base in f32 (TF32 off) on the card against the
    CPU, 100 frames (not a whole number of key tiles): encode,
    decode_train and decode_step logits within 1e-5 of max|out|, greedy
    tokens equal; K6 launched once per encoder layer and twice per
    decoder layer a call on the card, never on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as WH
    cfg = get_config(WHISPER["arch"]).reduced().replace(dtype="float32")
    cpu = WH.init_params(cfg, torch.Generator().manual_seed(SERVE_SEED))
    g = torch.Generator().manual_seed(SERVE_SEED + 5)
    fr = torch.randn((clips, frames, cfg.d_model), generator=g)
    prompt = torch.randint(0, cfg.vocab_size, (clips, 4), generator=g)
    out = {}
    for name, p, d in (("cpu", cpu, torch.device("cpu")),
                       ("cuda", to_device(cpu, dev), dev)):
        FK.reset_launch_counts()
        with torch.no_grad():
            enc = WH.encode(p, cfg, fr.to(d))
            fed, logits, chosen, _ = whisper_decode(p, cfg, enc, prompt.to(d),
                                                    new, 32)
            train = L.lm_logits(p["embed"], cfg, WH.decode_train(
                p, cfg, enc, fed)).float()
        steps = fed.shape[1]
        want = (cfg.n_enc_layers + 2 * cfg.n_dec_layers * (steps + 1)
                if name == "cuda" else 0)
        launched = FK.launch_counts()["flash_attention_fwd"]
        check(launched == want, f"reduced whisper on {name}: {launched} K6 "
              f"launches, want {want}")
        out[name] = [t.cpu() for t in (enc, train, logits, chosen)]
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(out["cuda"][:3], out["cpu"][:3])]
    check(max(rels) <= 1e-5, f"whisper card vs CPU: encode, decode_train, "
          f"decode_step rel {rels} > 1e-5")
    check(torch.equal(out["cuda"][3], out["cpu"][3]), "whisper: card and "
          "CPU choose different greedy tokens")
    log(f"[whisper] card vs CPU, reduced whisper-base f32 ({clips} clips of "
        f"{frames} frames, {new} greedy tokens): encode, decode_train and "
        f"decode_step rel {', '.join(f'{r:.3e}' for r in rels)} (≤1e-5); "
        f"greedy tokens equal")
    return max(rels)


def phase_whisper(dev, c=WHISPER):
    """whisper-base at full width (6 + 6 layers, d_model 512, bf16,
    weights drawn on the card from the seed) through the reference's
    entry points: ``encode`` of 8 clips of 1500 stub frame embeddings,
    ``init_cache(max_len=448)``, 4 prompt tokens then greedy tokens
    through ``decode_step`` until 64 are chosen.  K6 launches = 6 an
    encode + 12 a step; decode_step logits against decode_train's over
    the first 64 tokens within 5e-2 of max|logit|; the MMA kernel in the
    encoder's and decode_train's traces, the split kernels in a step's;
    20 steps traced (busy, K6, cuBLAS, other device ms, idle) beside the
    step's bound; the card against the CPU on the reduced config.  →
    (row, {"encode": K6 launches, "decode_steps": K6 launches})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import whisper as WH
    t_phase = time.perf_counter()
    cfg = get_config(c["arch"])
    t0 = time.perf_counter()
    params = WH.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_numel(params)
    want = whisper_expected_params(cfg)
    check(n_params == want, f"whisper: {n_params} parameters, want {want}")
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED + 4)
    frames = torch.randn((c["clips"], c["frames"], cfg.d_model), generator=g,
                         device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (c["clips"], c["prompt"]),
                           generator=g, device=dev)
    with torch.no_grad():
        FK.reset_launch_counts()
        encode_ms = []
        for _ in range(2):              # the first call, then a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = WH.encode(params, cfg, frames)
            torch.cuda.synchronize()
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        enc_launches = FK.launch_counts()["flash_attention_fwd"] // 2
        check(enc_launches == cfg.n_enc_layers, f"whisper encode: "
              f"{enc_launches} K6 launches a call, want {cfg.n_enc_layers}")
        FK.reset_launch_counts()
        t0 = time.perf_counter()
        fed, logits, chosen, cache = whisper_decode(
            params, cfg, enc, prompt, c["new"], c["max_len"])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        steps = fed.shape[1]
        step_launches = FK.launch_counts()["flash_attention_fwd"]
        check(step_launches == 2 * cfg.n_dec_layers * steps, f"whisper "
              f"decode: {step_launches} K6 launches, want 2 × "
              f"{cfg.n_dec_layers} × {steps} steps")
        check(bool(torch.isfinite(logits).all()), "whisper decode logits "
              "not finite")
        check(chosen.shape == (c["clips"], c["new"]) and bool(
            ((chosen >= 0) & (chosen < cfg.vocab_size)).all()),
            f"whisper: greedy tokens {tuple(chosen.shape)} or out of the "
            f"vocabulary")
        # decode_train over the first 64 fed tokens: Sq = 64, the MMA path
        s = min(64, steps)
        ref = L.lm_logits(params["embed"], cfg, WH.decode_train(
            params, cfg, enc, fed[:, :s])).float()
        rel = float((logits[:, :s] - ref).abs().max() / ref.abs().max())
        agree = float((logits[:, :s].argmax(-1) == ref.argmax(-1)).float()
                      .mean())
        check(rel <= 5e-2, f"whisper decode_step vs decode_train logits: "
              f"rel {rel} > 5e-2")
        log(f"[whisper] decode_step vs decode_train logits over {s} tokens "
            f"(bf16, full width): max |Δ| / max |logit| {rel:.3e} (≤5e-2); "
            f"greedy agree {agree:.3f}")
        kernels = {
            "encode": flash_kernels(lambda: WH.encode(params, cfg, frames)),
            "decode_train": flash_kernels(lambda: WH.decode_train(
                params, cfg, enc, fed[:, :s]))}
        for key, names in kernels.items():
            check(names == ["flash_fwd_mma_kernel"], f"whisper {key}: K6 "
                  f"ran {names}, not the MMA kernel")
        # steady decode: 20 steps traced, then 20 untraced
        tok, pos = chosen[:, -1:], steps
        with card_trace() as prof:
            t0 = time.perf_counter()
            for _ in range(c["window"]):
                lg, cache = WH.decode_step(params, cfg, tok, cache, pos)
                tok, pos = lg.argmax(-1, keepdim=True), pos + 1
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        k6_us, gemm_us, busy_us = serve_device_us(prof)
        names = sorted({m.group(0) for ev in prof.key_averages()
                        for m in [re.search(r"flash_fwd_\w+", ev.key)] if m})
        check(k6_us > 0 and names == ["flash_fwd_merge_kernel",
                                      "flash_fwd_split_kernel"],
              f"whisper decode step: K6 ran {names} ({k6_us} µs)")
        bound_bytes = whisper_step_bytes(params, cache, pos - 1)
        t0 = time.perf_counter()
        for _ in range(c["window"]):
            lg, cache = WH.decode_step(params, cfg, tok, cache, pos)
            tok, pos = lg.argmax(-1, keepdim=True), pos + 1
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / c["window"]
    n = c["window"]
    row = dict(arch=cfg.name, clips=c["clips"], frames=c["frames"],
               max_len=c["max_len"], prompt=c["prompt"], new=c["new"],
               n_params=n_params, param_gb=lm.param_bytes(params) / 1e9,
               init_s=init_s, cache_mb=lm.cache_bytes(cache) / 1e6,
               encode_first_ms=encode_ms[0], encode_ms=encode_ms[1],
               steps=steps,
               ms_per_step=decode_s / steps * 1e3,
               tokens_per_s=c["clips"] * c["new"] / decode_s,
               k6_launches_encode=enc_launches,
               k6_launches_steps=step_launches,
               decode_vs_train_rel=rel, decode_vs_train_greedy_agree=agree,
               kernels=kernels, step_kernels=names,
               steady=dict(steps=n, k6_device_ms_per_step=k6_us / 1e3 / n,
                           gemm_device_ms_per_step=gemm_us / 1e3 / n,
                           other_device_ms_per_step=(busy_us - k6_us - gemm_us)
                           / 1e3 / n,
                           device_busy_ms_per_step=busy_us / 1e3 / n,
                           traced_ms_per_step=traced_ms / n,
                           untraced_ms_per_step=untraced_ms,
                           idle_share_est=max(0.0, 1.0 - busy_us / 1e3 / n
                                              / untraced_ms),
                           positions=[steps, pos - 1],
                           step_bytes_gb=bound_bytes / 1e9,
                           step_bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3))
    log("[whisper] " + json.dumps(on_card(row)))
    del params, cache, enc, logits, ref
    torch.cuda.empty_cache()
    row["card_vs_cpu_rel"] = whisper_card_vs_cpu(dev)
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[whisper] {row['phase_s']:.1f} s")
    return row, {"encode": enc_launches, "decode_steps": step_launches}


def whisper_k6_inputs(dev, kind, seed, b=8, heads=8, hd=64, frames=1500,
                      max_len=448, pos=67):
    """K6's inputs at whisper-base's four calls (bf16, NH = KH = 8, hd
    64): ``encoder`` self-attention (Sq = Sk = 1500, not causal),
    ``train_cross`` (decode_train's cross-attention, Sq = 64 over 1500),
    ``step_cross`` (a decode step's, Sq = 1 over 1500; query positions 0,
    unused) and ``step_self`` (causal over a 448-slot cache holding
    positions 0..``pos``, the rest empty).  → (q, k, v, q_pos, kv_pos,
    causal)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    sq, sk = {"encoder": (frames, frames), "train_cross": (64, frames),
              "step_cross": (1, frames), "step_self": (1, max_len)}[kind]
    q, k, v = (torch.randn((b, n, heads, hd), generator=g, device=dev)
               .to(torch.bfloat16) for n in (sq, sk, sk))
    slots = torch.arange(sk, dtype=torch.int32, device=dev)
    if kind == "encoder":
        q_pos = slots.expand(b, sk).contiguous()
    elif kind == "step_self":
        q_pos = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        slots = torch.where(slots <= pos, slots, -1)
    else:
        q_pos = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    kv_pos = slots.expand(b, sk).contiguous()
    return q, k, v, q_pos, kv_pos, kind == "step_self"


WHISPER_K6 = {"encoder": ("mma", ["flash_fwd_mma_kernel"]),
              "train_cross": ("mma", ["flash_fwd_mma_kernel"]),
              "step_cross": ("split", ["flash_fwd_merge_kernel",
                                       "flash_fwd_split_kernel"]),
              "step_self": ("split", ["flash_fwd_merge_kernel",
                                      "flash_fwd_split_kernel"])}


def phase_whisper_kernels(dev, err):
    """K6 at whisper-base's four calls (``whisper_k6_inputs``) against its
    plain version (check_flash: within flash_tol, row 0 alone bitwise),
    the path ``plan()`` picks and the kernels its trace holds (MMA for the
    encoder and decode_train's cross-attention, split for a step's; the
    step's cross-attention in splits of 256), and its device and call ms
    beside the plain version's, SDPA's (timed only; no mask where every
    key is visible, a boolean one over the cache) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,
                                               position_mask)
    rows = {}
    for i, (kind, (path, want)) in enumerate(WHISPER_K6.items()):
        q, k, v, qp, kp, causal = whisper_k6_inputs(dev, kind, 90 + i)
        plan = FK.plan_of(q, k)
        check(plan[0] == path and (kind != "step_cross" or plan[1] == 256),
              f"whisper {kind}: plan {plan}, want the {path} path")
        tag = (f"whisper {kind} B={q.shape[0]} Sq={q.shape[1]} "
               f"Sk={k.shape[1]} NH=KH={q.shape[2]} hd={q.shape[3]} bf16 "
               f"{'causal' if causal else 'not causal'}")
        check_flash(tag, (q, k, v, qp, kp), err, causal=causal)
        mask = position_mask(qp, kp, causal, None)[:, None] \
            if kind == "step_self" else None
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        calls = {
            "flash": lambda: FK.flash_attention_fwd(q, k, v, qp, kp,
                                                    causal=causal),
            "flash_plain": lambda: flash_attention_fwd_ref(
                q, k, v, qp, kp, causal=causal),
            "flash_sdpa": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)}
        iters = 10 if kind == "encoder" else 50
        row = dict(shape=tag, plan=list(plan))
        for key, fn in calls.items():
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        row["flash_bound_ms"], row["flash_bound_by"] = flash_bound_ms(
            *flash_cost(q, k, qp, kp, causal=causal))
        row["flash_kernels"] = flash_kernels(calls["flash"])
        check(row["flash_kernels"] == want, f"{tag}: K6 ran "
              f"{row['flash_kernels']}, not {want}")
        ref = flash_attention_fwd_ref(q, k, v, qp, kp, causal=causal)
        row["max_abs_err"] = flash_err(calls["flash"](), ref)[0]
        rows[kind] = row
        log("[timing] " + json.dumps(on_card(row)))
        del q, k, v, ref
    torch.cuda.empty_cache()
    return rows


def kernel_us(fn, prefix, iters=3):
    """{kernel: device µs a call} of the kernels named ``prefix``* in a
    card_trace of ``iters`` calls of ``fn``."""
    out = {}
    for key, (_, us) in _trace(fn, iters).items():
        m = re.search(prefix + r"\w+", key)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / iters
    return dict(sorted(out.items()))


# the K5 kernels a call runs, whatever kvp_plan()'s geometry
KVP_KERNELS = ["kvp_fwd_kernel", "kvp_fwd_merge_kernel"]


def flash_kernels(fn):
    """The K6 kernels (flash_fwd_*) a card_trace of a few calls holds."""
    return list(kernel_us(fn, "flash_fwd_"))


def phase_slice3_timing(dev):
    """CUDA-event and profiler times of K6 at the decode shapes (B=8,
    NH=24, KH=8, hd=128, bf16, full cache Sk ∈ {512, 4096}), at a serving
    step (serving_step_inputs) and at the causal prefill (B=1, H=24,
    S=2048), with the K6 kernels each trace holds, and of K5 at (10, 544,
    20) and (1000, 2048, 20); their plain versions; SDPA at K6's shapes as
    the library yardstick (decode: boolean mask, enable_gqa; prefill:
    is_causal).  SDPA is timed only.  Rows: decode 512, decode 4096,
    serving step, prefill, K5 small, K5 large."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_fwd_ref,
                                               position_mask)
    from repro_torch.kernels.kvp import kernel as VK
    from repro_torch.kernels.kvp.ref import kvp_ref
    rows = []
    for sk in (512, 4096, "serving"):
        if sk == "serving":
            q, k, v, qp, kp = serving_step_inputs(dev, seed=64)
        else:
            q, k, v, qp, kp = full_cache_inputs(dev, 8, sk, 24, 8, 128,
                                                torch.bfloat16, seed=sk)
        mask = position_mask(qp, kp, True, None)[:, None]       # (B,1,1,Sk)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        calls = {
            "flash": lambda: FK.flash_attention_fwd(q, k, v, qp, kp),
            "flash_plain": lambda: flash_attention_fwd_ref(q, k, v, qp, kp),
            "flash_sdpa": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)}
        row = dict(shape=(f"decode B=8 Sk={sk}" if sk != "serving" else
                          "serving step B=8 Sk=512 positions 64-104"))
        for key, fn in calls.items():
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(
                fn, 50)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, 50)
        row["flash_bound_ms"], row["flash_bound_by"] = flash_bound_ms(
            *flash_cost(q, k, qp, kp))
        row["flash_kernels"] = flash_kernels(calls["flash"])
        check(row["flash_kernels"] == ["flash_fwd_merge_kernel",
                                       "flash_fwd_split_kernel"],
              f"{row['shape']}: K6 ran {row['flash_kernels']}")
        rows.append(row)
        log("[timing] " + json.dumps(on_card(row)))
    g = torch.Generator(device=dev).manual_seed(4)
    qb, kb, vb = (torch.randn((1, 24, 2048, 128), generator=g,
                              device=dev).to(torch.bfloat16)
                  for _ in range(3))
    pos = torch.arange(2048, dtype=torch.int32, device=dev)[None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
    calls = {
        "flash": lambda: FK.flash_attention_fwd(qt, kt, vt, pos, pos),
        "flash_plain": lambda: flash_attention_fwd_ref(qt, kt, vt, pos, pos),
        "flash_sdpa": lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True)}
    row = dict(shape="causal prefill B=1 H=24 S=2048")
    for key, fn in calls.items():
        row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, 10)
        row[f"{key}_call_ms"] = cuda_time_ms(fn, 10)
    row["flash_bound_ms"], row["flash_bound_by"] = flash_bound_ms(
        *flash_cost(qt, kt, pos, pos))
    row["flash_kernels"] = flash_kernels(calls["flash"])
    check(row["flash_kernels"] == ["flash_fwd_mma_kernel"],
          f"causal prefill: K6 ran {row['flash_kernels']}")
    rows.append(row)
    log("[timing] " + json.dumps(on_card(row)))
    for q, n, d, iters in ((10, 544, 20, 200), (1000, 2048, 20, 20)):
        xq, xt, al, ils, amp = kvp_inputs(q, n, d, dev, far=32)
        calls = {"kvp": lambda: VK.kvp_fwd(xq, xt, al, ils, amp),
                 "kvp_plain": lambda: kvp_ref(xq, xt, al, ils, amp)}
        row = dict(shape=f"kvp q={q} n={n} D={d}")
        for key, fn in calls.items():
            row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(
                fn, iters)
            row[f"{key}_call_ms"] = cuda_time_ms(fn, iters)
        row["kvp_bound_ms"], row["kvp_bound_by"] = bound_ms(
            *kvp_cost(q, n, d))
        row["kvp_rows_a_lane"] = VK.kvp_plan(q, n, d).rows
        row["kvp_us_by_kernel"] = kernel_us(calls["kvp"], "kvp_")
        check(list(row["kvp_us_by_kernel"]) == KVP_KERNELS,
              f"{row['shape']}: K5 ran {list(row['kvp_us_by_kernel'])}, "
              f"not {KVP_KERNELS}")
        rows.append(row)
        log("[timing] " + json.dumps(on_card(row)))
    return rows


# ------------------------------------------- slice 5: the paper's examples
PAPER_RUNS = 3


def phase_paper(dev, state, sampler):
    """The paper's examples on the card (examples/*_torch.py) and the BO
    numerics no suggest path calls.  Rosenbrock (B=10, D=5): the paper
    twin's four strategies through maximize_acqf(acq_state=None), that is
    the default engine on the card, PAPER_RUNS times: C3 bitwise (x,
    n_iters, n_evals), C2's inflation, median rounds and wall ms per
    strategy; the same four strategies on the fitted GP state of the main
    phase; the lockstep solve's dense inverse Hessian against the two-loop
    recursion on each basis vector (1e-12) and dense BFGS on the same
    batch; a q=2 qLogEI MSO on the GP state (finite, in bounds); then the
    quickstart twin (K1 = K2 = MSO rounds, K4 = fit evaluations) and the
    serve twin (K6 = layers × steps), each with the counts set to 0 just
    before it and read just after."""
    import statistics
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import paper_repro_torch
    import quickstart_torch
    import serve_batched_torch
    from repro_torch.core import lbfgsb as L
    from repro_torch.core.acquisition import qlogei_acq, qlogei_state
    from repro_torch.core.mso import MsoOptions, maximize_acqf
    from repro_torch.engine.engine import default_engine
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.matern import kernel as K
    gpu = card()
    strategies = paper_repro_torch.STRATEGIES

    def medians(runs):
        return {st: dict(
            rounds=statistics.median(r[st].n_rounds for r in runs),
            wall_ms=statistics.median(1e3 * r[st].wall_time for r in runs),
            median_iters=statistics.median(float(np.median(r[st].n_iters))
                                           for r in runs))
            for st in strategies}

    # Rosenbrock through the default engine, on the card
    runs = []
    for i in range(PAPER_RUNS):
        out = paper_repro_torch.run(None, verbose=False)
        res = out["results"]
        check(out["c3"], f"paper run {i}: C3 (D-BE == SEQ, bitwise x, "
              f"n_iters, n_evals) does not hold")
        for st in strategies:
            check(np.all(np.isfinite(res[st].x)) and res[st].best_acq > -1e-6,
                  f"paper run {i}: {st} best {res[st].best_acq}")
        if runs:
            check(all(np.array_equal(res[st].x, runs[0][st].x)
                      for st in strategies),
                  f"paper run {i}: not bitwise run 0")
        runs.append(res)
    eng = default_engine(paper_repro_torch.neg_rosen)
    check(eng.device.type == "cuda" and eng.stats.n_rounds > 0,
          "paper: the default engine is not the card's")
    rosen = dict(c2_inflation=out["c2_inflation"], runs=PAPER_RUNS,
                 strategies=medians(runs), card=gpu)
    log("[paper] rosenbrock B=10 D=5 (default engine, C3 bitwise in every "
        "run): " + json.dumps(rosen))

    # the same strategies on the main phase's fitted GP state (D=20)
    gp, best = state
    D = sampler.space.dim
    rng = np.random.default_rng(3)
    x0 = np.concatenate([sampler.space.to_unit(sampler.best().x)[None],
                         rng.uniform(0, 1, (sampler.B - 1, D))], 0)
    gruns = []
    for _ in range(PAPER_RUNS):
        gruns.append({st: maximize_acqf(sampler._acq_fn, x0, 0.0, 1.0,
                                        acq_state=state, strategy=st,
                                        options=sampler.mso_options)
                      for st in strategies})
        check(np.array_equal(gruns[-1]["seq"].x, gruns[-1]["dbe"].x),
              "paper: C3 on the GP state")
    med = medians(gruns)
    gp_row = dict(
        c2_inflation=med["cbe"]["median_iters"]
        / med["dbe"]["median_iters"], runs=PAPER_RUNS, strategies=med,
        dbe_beats_cbe=med["dbe"]["wall_ms"] < med["cbe"]["wall_ms"],
        card=gpu)
    log(f"[paper] LogEI on the fitted GP state (n={gp.x_train.shape[0]}, "
        f"D={D}, B={sampler.B}): "
        + json.dumps(gp_row))

    # the dense inverse Hessian and dense BFGS on the Rosenbrock batch
    def rosen_one(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2
                + (1.0 - x[:-1]) ** 2).sum()
    fb = L.make_batched_value_and_grad(rosen_one)
    xr = torch.as_tensor(np.random.default_rng(0).uniform(0, 3, (10, 5)),
                         device=dev)
    res = L.lbfgsb_minimize(fb, xr, 0.0, 3.0, L.LbfgsbOptions(
        m=10, maxiter=200, pgtol=1e-8, ftol=0.0))
    H = L.inv_hessian_dense(res.state, 10)
    hist = L._ordered_history(res.state, 10)
    herr = 0.0
    for j in range(5):
        e = torch.zeros_like(xr)
        e[:, j] = 1.0
        col = L.two_loop_direction(e, *hist, res.state.gamma)
        herr = max(herr, float((H[:, :, j] - col).abs().max()))
    check(herr <= 1e-12 and bool(torch.isfinite(H).all()),
          f"inv_hessian_dense off the two-loop columns by {herr}")
    # unbounded: a row may settle in Rosenbrock's local minimum (f ≈ 3.93)
    bf = L.bfgs_minimize(fb, xr, maxiter=300, gtol=1e-9)
    conv = bf.status == L.CONV_PGTOL
    f0, _ = fb(xr)
    _, g_end = fb(bf.x)
    check(bool(torch.isfinite(bf.x).all()) and bool((bf.f <= f0).all())
          and bool(conv.any()) and float(bf.f.min()) < 1e-8
          and float(g_end[conv].abs().max()) <= 1e-9,
          f"bfgs_minimize: status {bf.status.tolist()}, f {bf.f.tolist()}")
    log(f"[paper] inv_hessian_dense vs the two-loop columns: max |Δ| "
        f"{herr:.3e} (≤ 1e-12); bfgs_minimize on the same batch: k "
        f"{bf.k.tolist()}, status {bf.status.tolist()}, f "
        f"{[float(f'{v:.3e}') for v in bf.f.tolist()]}")

    # one joint q=2 qLogEI MSO on the main phase's GP state
    qstate = qlogei_state(gp, best, 2, seed=0)
    xq0 = rng.uniform(0, 1, (sampler.B, 2, D))
    t0 = time.perf_counter()
    r = maximize_acqf(qlogei_acq, xq0, 0.0, 1.0, acq_state=qstate,
                      strategy="dbe_vec", q=2,
                      options=MsoOptions(maxiter=50, pgtol=1e-2))
    q_ms = (time.perf_counter() - t0) * 1e3
    check(r.best_x.shape == (2, D) and bool(np.all(np.isfinite(r.x)))
          and bool(np.all((r.x >= 0) & (r.x <= 1)))
          and np.isfinite(r.best_acq),
          f"qLogEI q=2: best {r.best_acq}, x in [{r.x.min()}, {r.x.max()}]")
    log(f"[paper] qLogEI q=2 MSO on the GP state: best {r.best_acq:.4f}, "
        f"{r.n_rounds} rounds, {q_ms:.1f} ms; {gpu}")

    # the quickstart twin: GPSampler dbe, D=5 Rastrigin, 40 trials
    K.reset_launch_counts()
    t0 = time.perf_counter()
    qs = quickstart_torch.main([])
    qs_s = time.perf_counter() - t0
    ql = K.launch_counts()
    mso_rounds = int(sum(qs.stats.acqf_rounds))
    fit_evals = ql["matern52_gram_bwd_theta"]
    check(qs.device.type == "cuda" and qs.posterior_backend == "fused",
          f"quickstart on {qs.device} / {qs.posterior_backend}")
    check(ql["matern52_posterior_fwd"] == ql["matern52_posterior_bwd_xq"]
          == mso_rounds > 0, f"quickstart: K1/K2 {ql} != MSO rounds "
          f"{mso_rounds}")
    # each fit: one K3 and one K4 an evaluation, one K3 for its last gram
    check(fit_evals > 0 and ql["matern52_gram_fwd"] - fit_evals
          == qs.stats.n_gp_fits, f"quickstart: K3 {ql} != fit evaluations "
          f"+ fits ({qs.stats.n_gp_fits})")
    log(f"[paper] quickstart twin: {len(qs.trials)} trials in {qs_s:.1f} s, "
        f"best {qs.best().y:.4f}; launches {json.dumps(ql)} = MSO rounds "
        f"{mso_rounds}, fit evaluations {fit_evals}, GP fits "
        f"{qs.stats.n_gp_fits}; {gpu}")

    # the serve twin: reduced llama3.2-3b in f32, 4 slots, 10 requests
    FK.reset_launch_counts()
    t0 = time.perf_counter()
    sv = serve_batched_torch.main([])
    sv_s = time.perf_counter() - t0
    fl = FK.launch_counts()["flash_attention_fwd"]
    layers = sv.cfg.n_layers
    check(sv.device.type == "cuda" and sv.stats["compiles"] == 1
          and fl == sv.stats["flash_launches"] == layers * sv.stats["steps"]
          > 0 and sv.stats["tokens"] == 120,
          f"serve twin: K6 {fl}, stats {sv.stats}, layers {layers}")
    log(f"[paper] serve twin: {sv.stats['tokens']} tokens in "
        f"{sv.stats['steps']} steps, {sv_s:.2f} s; K6 launches {fl} = "
        f"{layers} layers × {sv.stats['steps']} steps; {gpu}")
    return dict(rosenbrock=rosen, gp_state=gp_row, qlogei_ms=q_ms,
                launches=dict(quickstart=ql, serve=fl),
                quickstart_mso_rounds=mso_rounds,
                quickstart_fit_evals=fit_evals)


# ------------------------------------------------- slice 4: the fleet plane
# the fleet phase's full-width cell and its smaller checks; a CPU rehearsal
# passes smaller ones.  542 startup trials put a full refit, rank-one
# refits and the 544 → 576 migration's full refit in the first 4 rounds,
# the ones held against the solo samplers; 8 rounds, since a full round,
# its Cholesky factorizations study by study, takes ~12 s
FLEET = dict(D=20, studies=16, slots=8, B=10, pad=32, refit_interval=8,
             startup=542, rounds=8, solo_rounds=4,
             bits=dict(D=20, n=40, steps=4), recover=dict(D=5, rounds=12, kill_at=50))


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def on_card(row: dict) -> dict:
    """A timing row with the card's name and power limit beside it."""
    return {**row, "card": card()}


def fleet_kw(c):
    return dict(n_startup_trials=c["startup"], n_restarts=c["B"],
                pad_multiple=c["pad"], gp_fit_restarts=2,
                refit_interval=c["refit_interval"],
                posterior_backend=c.get("backend", "auto"))


def phase_fleet_kernels(dev, err):
    """K1–K4 with a leading study axis at S ∈ {1, 3, 8}, n ∈ {33, 544},
    D ∈ {5, 20}, study s with its own θ and 3 + 7s _FAR rows (K1/K2) or
    2 + 5s (K3/K4): one launch a call for the S studies, each study's
    slice bitwise its solo call and within the stated tolerances of the
    plain versions (the solo checks of phase 2, study by study)."""
    import numpy as np
    import torch
    from repro_torch.kernels.matern import kernel as K
    rng = np.random.default_rng(11)
    for S in (1, 3, 8):
        for n in (33, 544):
            for d in (5, 20):
                tag = f"studies S={S} n={n} D={d}"
                gps = [make_state(n, d, seed=10 * s + n + d, device=dev,
                                  n_pad=min(3 + 7 * s, n - 2))
                       for s in range(S)]
                xt, alpha, kinv, ils, amp = (
                    torch.stack(list(a)) for a in zip(*map(kernel_args,
                                                           gps)))
                # each study its own θ
                ils = ils * (1 + 0.1 * torch.arange(S, device=dev))[:, None]
                amp = amp * (1 + 0.05 * torch.arange(S, device=dev))
                xq = torch.as_tensor(rng.uniform(0, 1, (S, 10, d))).to(dev)
                xq[:, 0] = xt[:, 0]
                gm = torch.as_tensor(rng.standard_normal((S, 10))).to(dev)
                gv = torch.as_tensor(rng.standard_normal((S, 10))).to(dev)
                K.reset_launch_counts()
                m, v, t = K.matern52_posterior_fwd(xq, xt, alpha, kinv, ils,
                                                   amp)
                g = K.matern52_posterior_bwd_xq(xq, xt, alpha, t, v, ils,
                                                amp, gm, gv)
                far = [min(2 + 5 * s, n - 2) for s in range(S)]
                gin = [gram_inputs(n, n, d, 2, dev, far[s], seed=s)
                       for s in range(S)]
                x, gils, gamp, gg = (torch.stack([i[j] for i in gin])
                                     for j in (0, 2, 3, 4))
                k3 = K.matern52_gram_fwd(x, x, gils, gamp)
                k4 = K.matern52_gram_bwd_theta(x, x, gils, gamp, gg)
                torch.cuda.synchronize()
                check(K.launch_counts() == {
                    "matern52_posterior_fwd": 1,
                    "matern52_posterior_bwd_xq": 1,
                    "matern52_gram_fwd": 1, "matern52_gram_bwd_theta": 1},
                    f"{tag}: not one launch a kernel: {K.launch_counts()}")
                for s in range(S):
                    one = (xt[s], alpha[s], kinv[s], ils[s], amp[s])
                    m1, v1, t1 = K.matern52_posterior_fwd(xq[s], *one)
                    g1 = K.matern52_posterior_bwd_xq(
                        xq[s], xt[s], alpha[s], t1, v1, ils[s], amp[s],
                        gm[s], gv[s])
                    k31 = K.matern52_gram_fwd(x[s], x[s], gils[s], gamp[s])
                    k41 = K.matern52_gram_bwd_theta(x[s], x[s], gils[s],
                                                    gamp[s], gg[s])
                    for name, a, b in (
                            ("K1 mean", m1, m[s]), ("K1 var", v1, v[s]),
                            ("K1 t", t1, t[s]), ("K2", g1, g[s]),
                            ("K3", k31, k3[s]), ("K4 1/ℓ", k41[0], k4[0][s]),
                            ("K4 σ²", k41[1], k4[1][s])):
                        check(torch.equal(a, b), f"{tag}: {name} of study "
                              f"{s} differs from its solo call")
                    gp = gps[s]
                    gp.params.log_lengthscale = -torch.log(ils[s])
                    gp.params.log_amplitude = torch.log(amp[s])
                    check_against_plain(gp, 10, rng, err, f"{tag} s={s}",
                                        xq=xq[s])
                    check_gram(f"{tag} s={s}",
                               (x[s], x[s], gils[s], gamp[s], gg[s]),
                               far[s], err)
        log(f"[fleet kernels] S={S}: K1–K4 one launch each, every study "
            f"bitwise its solo call, within tolerance of the plain versions")


class FleetHooks:
    """The fleet's fault hooks, all passing everything through."""

    def incr_ok(self, ok, sids):
        return ok

    def full_ok(self, ok, sids):
        return ok


class KillAt(FleetHooks):
    """Journal fault hook: a kill (a torn record, then InjectedCrash) at
    journal seq ``seq``, once."""

    def __init__(self, seq: int):
        self.seq = seq

    def should_kill(self, seq: int) -> bool:
        if self.seq is not None and seq >= self.seq:
            self.seq = None
            return True
        return False


class VetoAll(FleetHooks):
    """Fleet fault hook: vetoes every rank-one update of one step, so
    every requesting study takes the full refit (the fallback)."""

    def incr_ok(self, ok, sids):
        return ok * 0


def fleet_rounds(fs, obj, rounds):
    """Drive ``rounds`` ask_all/tell rounds; per round the host ms (to a
    synchronize), the n each suggestion saw and the kinds, and every
    study's suggestions (rounds, studies, D)."""
    import collections
    import numpy as np
    import torch
    rows, xs = [], []
    for _ in range(rounds):
        n = len(fs.samplers[0].trials)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = fs.ask_all()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        kinds = collections.Counter(
            s.last_ask_info.kind if s.last_ask_info else "startup"
            for s in fs.samplers)
        rows.append(dict(n=n, ms=wall, kinds=dict(kinds)))
        xs.append(np.array([t.x for t in trials]))
        for i, t in enumerate(trials):
            fs.tell(i, t.trial_id, obj(t.x))
    return rows, np.array(xs)


def startup(samplers_or_fleet, obj, n):
    """The random startup trials (host only)."""
    from repro_torch.bo.sampler import FleetSampler
    for _ in range(n):
        if isinstance(samplers_or_fleet, FleetSampler):
            for i, t in enumerate(samplers_or_fleet.ask_all()):
                samplers_or_fleet.tell(i, t.trial_id, obj(t.x))
        else:
            t = samplers_or_fleet.ask()
            samplers_or_fleet.tell(t.trial_id, obj(t.x))


def fleet_bits(dev, c):
    """Slot permutation and solo-in-a-block, bitwise, on a smaller fleet:
    3 studies of D = c["bits"]["D"] with n observations each on a
    slots-wide block, stepped through full and incremental refits
    (refit_interval=2) with the studies admitted in two orders, and each
    study alone in a block of the same width."""
    import numpy as np
    from repro_torch.bo.objectives import make_objective
    from repro_torch.core.lbfgsb import LbfgsbOptions
    from repro_torch.engine.engine import EvalEngine
    from repro_torch.engine.fleet import FleetConfig, FleetEngine, \
        default_draws
    from repro_torch.engine.posterior import fused_logei_acq
    b = c["bits"]
    d = b["D"]
    obj = make_objective("rastrigin", d)
    rng = np.random.default_rng(5)
    obs_ = {s: rng.uniform(0, 1, (b["n"], d)) for s in range(3)}
    cfg = FleetConfig(dim=d, n_restarts=c["B"], slots=c["slots"],
                      backend="fused", pad_bucket=c["pad"],
                      refit_interval=2, mso=LbfgsbOptions(
                          m=10, maxiter=200, pgtol=1e-2, ftol=0.0, maxls=25))

    def run(order):
        fleet = FleetEngine(EvalEngine(fused_logei_acq("fused"), dev), cfg)
        for sid in order:
            fleet.add_study(sid)
            for x in obs_[sid]:
                fleet.observe(sid, x, obj(-5 + 10 * x))
        out = {}
        for step in range(b["steps"]):
            for sid in order:
                fleet.request_suggest(sid, default_draws(sid, step,
                                                         c["B"] - 1, d),
                                      fit_seed=sid + step)
            fleet.step()
            for sid in order:
                x, info = fleet.pop_result(sid)
                out.setdefault(sid, []).append((x, info.kind))
                fleet.observe(sid, x, obj(-5 + 10 * x))
        return out

    runs = {"order 0 1 2": run([0, 1, 2]), "order 2 0 1": run([2, 0, 1])}
    for sid in range(3):
        runs[f"alone {sid}"] = run([sid])
    base = runs["order 0 1 2"]
    kinds = [k for _, k in base[0]]
    check(kinds[:2] == ["full", "incremental"], f"bits: kinds {kinds}")
    for name, r in runs.items():
        for sid in r:
            for (xa, ka), (xb, kb) in zip(base[sid], r[sid]):
                check(ka == kb and np.array_equal(xa, xb),
                      f"fleet bits: study {sid} differs in {name}")
    log(f"[fleet] bits: 3 studies, D={d}, n={b['n']}, slots={c['slots']}, "
        f"{b['steps']} steps ({kinds}): slot permutation and alone in a "
        f"block bitwise")


def fleet_recovery(c):
    """A small fleet at refit_interval=1 killed mid-journal and recovered:
    every study's trajectory bitwise the uninterrupted twin's."""
    import tempfile
    import numpy as np
    from repro_torch.bo.journal import InjectedCrash
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import FleetSampler
    from repro_torch.bo.space import BoxSpace
    r = c["recover"]
    d, rounds = r["D"], r["rounds"]
    obj = make_objective("rastrigin", d)
    space = BoxSpace.cube(d, -5.0, 5.0)
    kw = dict(n_startup_trials=6, n_restarts=c["B"], pad_multiple=8,
              slots=2, refit_interval=1, warm_start=False)
    ref = FleetSampler([space] * 2, seed=0, **kw)
    fleet_rounds(ref, obj, rounds)
    with tempfile.TemporaryDirectory() as tmp:
        vic = FleetSampler([space] * 2, seed=0, journal_dir=tmp,
                           fault_injector=KillAt(r["kill_at"]), **kw)
        crashed = False
        try:
            for i in range(rounds):
                if i == 7:
                    vic.checkpoint()
                fleet_rounds(vic, obj, 1)
        except InjectedCrash:
            crashed = True
        check(crashed, "recovery: the injected kill did not fire")
        fs, rep = FleetSampler.recover(tmp)
        for i, tid in rep.pending:
            fs.tell(i, tid, obj(fs.samplers[i].trials[tid].x))
        done = min(len(s.trials) for s in fs.samplers)
        fleet_rounds(fs, obj, rounds - done + 1)
    for i in range(2):
        a, b = ref.samplers[i].trials, fs.samplers[i].trials
        check(min(len(a), len(b)) == rounds, "recovery: too few trials")
        for ta, tb in zip(a, b):
            check(np.array_equal(ta.x, tb.x),
                  f"recovery: study {i} trial {ta.trial_id} differs")
    log(f"[fleet] recovery: killed at journal seq {r['kill_at']} (snapshot "
        f"step "
        f"{rep.snapshot_step}, {rep.n_replayed} of {rep.n_records} records "
        f"replayed, {rep.truncated_bytes} torn bytes dropped), D={d}, "
        f"{rounds} rounds: both studies bitwise the uninterrupted run")


def fleet_timing(dev):
    """K1–K4's device µs at the fleet's shapes (S = 8, q = 10, n = 544,
    D = 20; K3/K4 S = 8, R = 2, x1 is x2) beside their bounds (S × the
    solo call's bytes and operations) and 8 × the solo call's µs."""
    import numpy as np
    import torch
    from repro_torch.kernels.matern import kernel as K
    S, q, n, d, R = 8, 10, 544, 20, 2
    gps = [make_state(n, d, seed=s, device=dev, n_pad=3 + 4 * s)
           for s in range(S)]
    xt, alpha, kinv, ils, amp = (torch.stack(list(a)) for a in
                                 zip(*map(kernel_args, gps)))
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.uniform(0, 1, (S, q, d))).to(dev)
    _, v, t = K.matern52_posterior_fwd(xq, xt, alpha, kinv, ils, amp)
    ones = torch.ones_like(v)
    gin = [gram_inputs(n, n, d, R, dev, 32, seed=s) for s in range(S)]
    x, gils, gamp, gg = (torch.stack([i[j] for i in gin])
                         for j in (0, 2, 3, 4))
    calls = {
        "fwd": (lambda: K.matern52_posterior_fwd(xq, xt, alpha, kinv, ils,
                                                 amp),
                lambda: K.matern52_posterior_fwd(xq[0], xt[0], alpha[0],
                                                 kinv[0], ils[0], amp[0]),
                fwd_cost(q, n, d)),
        "bwd": (lambda: K.matern52_posterior_bwd_xq(xq, xt, alpha, t, v, ils,
                                                    amp, ones, -0.5 * ones),
                lambda: K.matern52_posterior_bwd_xq(
                    xq[0], xt[0], alpha[0], t[0], v[0], ils[0], amp[0],
                    ones[0], -0.5 * ones[0]),
                bwd_cost(q, n, d)),
        "gram_fwd": (lambda: K.matern52_gram_fwd(x, x, gils, gamp),
                     lambda: K.matern52_gram_fwd(x[0], x[0], gils[0],
                                                 gamp[0]),
                     gram_cost(R, n, n, d, False)),
        "gram_bwd": (lambda: K.matern52_gram_bwd_theta(x, x, gils, gamp, gg),
                     lambda: K.matern52_gram_bwd_theta(x[0], x[0], gils[0],
                                                       gamp[0], gg[0]),
                     gram_cost(R, n, n, d, True))}
    out = {}
    for key, (many, one, cost) in calls.items():
        ms, src = device_ms(many, 20)
        ms1, src1 = device_ms(one, 20)
        bnd, by = bound_ms(*(S * c_ for c_ in cost))
        out[key] = dict(fleet_ms=ms, fleet_ms_from=src, solo_ms=ms1,
                        solo8_ms=S * ms1, solo_ms_from=src1,
                        fleet_bound_ms=bnd, fleet_bound_by=by)
        log(f"[fleet timing] {key} S={S}: {ms * 1e3:.2f} µs ({src}), "
            f"8 × solo {S * ms1 * 1e3:.2f} µs, bound {bnd * 1e3:.2f} µs "
            f"({by}); {card()}")
    return out


def traced_round(fs, obj):
    """One fleet round traced on the card: host ms to a synchronize,
    device ms by kernel class, and the idle share 1 − busy / host."""
    import torch
    with card_trace() as prof:
        t0 = time.perf_counter()
        trials = fs.ask_all()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for i, t in enumerate(trials):
        fs.tell(i, t.trial_id, obj(t.x))
    dev_us = device_breakdown(prof)
    busy = sum(dev_us.values()) / 1e3
    check(busy > 0, "profiler saw no device time in a fleet round")
    kinds = sorted({s.last_ask_info.kind for s in fs.samplers})
    return dict(kinds=kinds, host_ms=wall_ms, device_ms=busy,
                device_idle_share=1.0 - busy / wall_ms,
                device_ms_by_class={k: v / 1e3 for k, v in dev_us.items()})


def fleet_layers(c, fs, state0, draws0, seeds0, x_round0):
    """The fleet's round 0 against the solo programs, layer by layer, for
    every study, all bitwise: (1) one MAP-objective evaluation (value and
    θ-gradient) of the study's slot in its block's stack against the study
    alone; (2) the full refit's θ, Cholesky factor, α and K⁻¹ against
    ``refit_core`` on the study alone; (3) the MSO tail from the fleet's
    fitted state, run solo with the same draws, against the fleet's
    suggestion."""
    import numpy as np
    import torch
    from repro_torch.engine.ask import AskConfig, AskEngine, refit_core
    from repro_torch.engine.engine import EvalEngine
    from repro_torch.engine.posterior import fused_logei_acq
    from repro_torch.gp.fit import (FIT_OPTS, _neg_map_objective,
                                    standardize_masked, theta_bounds,
                                    theta_init_grid, unpack_theta)
    D, R = c["D"], 2
    dev = fs.fleet.device
    tlo, tup = theta_bounds(D, torch.float64, dev)
    ask = AskEngine(EvalEngine(fused_logei_acq("fused"), dev),
                    AskConfig(dim=D, n_restarts=c["B"], backend="fused",
                              pad_bucket=c["pad"],
                              refit_interval=c["refit_interval"]))

    def objective(theta, x, y_std, valid):
        theta = theta.detach().requires_grad_(True)
        f = _neg_map_objective(theta, x, y_std, valid, D, "matern52")
        (g,) = torch.autograd.grad(f.sum(), theta)
        return f.detach(), g

    def dmax(a, b):
        return 0.0 if torch.equal(a, b) else float((a - b).abs().max())

    out = dict(objective=0.0, gradient=0.0, theta=0.0, chol=0.0, alpha=0.0,
               kinv=0.0)
    blocks = {}
    for sid, st in state0.items():
        blocks.setdefault(id(st["block"]), []).append(sid)
    for sids in blocks.values():
        # one evaluation of the whole stack at the round's θ inits
        order = sorted(sids, key=lambda i: state0[i]["slot"])
        x = torch.stack([state0[i]["x"] for i in order])
        y = torch.stack([state0[i]["y"] for i in order])
        nv = torch.tensor([state0[i]["n"] for i in order], device=dev)
        valid = torch.arange(x.shape[1], device=dev) < nv[:, None]
        y_std = standardize_masked(-y, valid)[0]
        thetas = torch.stack([theta_init_grid(D, torch.float64, R,
                                              seeds0[i]) for i in order])
        f_all, g_all = objective(thetas.to(dev), x, y_std, valid)
        for j, i in enumerate(order):
            st = state0[i]
            th = thetas[j].to(dev)
            f1, g1 = objective(th, x[j], y_std[j], valid[j])
            out["objective"] = max(out["objective"], dmax(f_all[j], f1))
            out["gradient"] = max(out["gradient"], dmax(g_all[j], g1))
            r1 = refit_core(st["x"], st["y"], st["n"], th,
                            tlo.expand(th.shape), tup.expand(th.shape),
                            dim=D, kernel="matern52", backend="fused",
                            fit_opts=FIT_OPTS)
            for key, v in (("theta", r1[2]), ("chol", r1[3]),
                           ("alpha", r1[4]), ("kinv", r1[5])):
                out[key] = max(out[key], dmax(v, st[key]))
            # the MSO tail from the fleet's own fitted state, solo
            v1 = torch.arange(x.shape[1], device=dev) < st["n"]
            ys1 = standardize_masked(-st["y"], v1)[0]
            bx, _ = ask._mso_tail(draws0[i].to(dev), st["x"], ys1, v1,
                                  unpack_theta(st["theta"], D), st["chol"],
                                  st["alpha"], st["kinv"])
            sp = fs.samplers[i].space
            x_solo = sp.from_unit(np.clip(bx.cpu().numpy(), 0.0, 1.0))
            check(np.array_equal(x_solo, x_round0[i]),
                  f"fleet layers: study {i}'s MSO from its fitted state "
                  f"differs from the fleet's suggestion by "
                  f"{np.abs(x_solo - x_round0[i]).max()}")
    log(f"[fleet] layers, round 0, every study against its solo "
        f"programs: max |Δ| MAP objective {out['objective']:.3e}, "
        f"θ-gradient {out['gradient']:.3e}; refit θ {out['theta']:.3e}, "
        f"chol {out['chol']:.3e}, α {out['alpha']:.3e}, K⁻¹ "
        f"{out['kinv']:.3e} (all must be 0); MSO from the fleet's state "
        f"bitwise the fleet's suggestion")
    for key, v in out.items():
        check(v == 0.0, f"fleet layers: {key} off its solo bits by {v}")
    return out


def phase_fleet(dev, c=FLEET):
    """The fleet plane at full width: c["studies"] Rastrigin studies of
    D = c["D"] (seeds 0–15) on c["slots"]-wide blocks, B = 10, R = 2,
    refit every 8th trial, c["startup"] random trials then c["rounds"]
    fleet rounds across the 544 → 576 bucket.  Launches, programs, the
    solo pipeline to 1e-10, throughput against the studies run solo in
    turn, and a traced round's device time; then the bitwise and
    recovery checks on smaller fleets."""
    import numpy as np
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import FleetSampler, GPSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.kernels.matern import kernel as K

    D, S = c["D"], c["studies"]
    obj = make_objective("rastrigin", D)
    space = BoxSpace.cube(D, -5.0, 5.0)
    fs = FleetSampler(space, n_studies=S, seed=0, slots=c["slots"],
                      **fleet_kw(c))
    check(fs.fleet.cfg.backend == "fused", "fleet not on the fused backend")
    startup(fs, obj, c["startup"])
    # round 0's restart draws and fit seeds, and the blocks' state after
    # it, for the layer-by-layer check against the solo programs
    draws0 = [s._restart_draws() for s in fs.samplers]
    seeds0 = [s.seed + len(s.trials) for s in fs.samplers]
    snap0 = fs.fleet.stats_snapshot()
    K.reset_launch_counts()
    rows, xs = fleet_rounds(fs, obj, 1)
    state0 = {}
    for blk in fs.fleet._blocks:
        for slot, st in enumerate(blk.studies):
            if st is not None:
                state0[st.sid] = dict(
                    slot=slot, n=st.n, x=blk.x[slot].clone(),
                    y=blk.y[slot].clone(), theta=blk.theta[slot].clone(),
                    chol=blk.chol[slot].clone(),
                    alpha=blk.alpha[slot].clone(),
                    kinv=blk.kinv[slot].clone(), block=blk)
    more, xs_more = fleet_rounds(fs, obj, c["rounds"] - 1)
    rows, xs = rows + more, np.concatenate([xs, xs_more])
    launches = K.launch_counts()
    snap = fs.fleet.stats_snapshot()
    delta = {k: snap[k] - snap0[k] for k in ("n_mso_rounds", "n_fit_evals")}
    progs = {k: snap["n_block_programs"][k] - snap0["n_block_programs"][k]
             for k in ("full", "incr", "mso")}
    for r in rows:
        log("[fleet] round: " + json.dumps(on_card(r)))
    check(bool(np.all(np.isfinite(xs))) and bool(np.all(np.abs(xs) <= 5)),
          "fleet suggestions not finite or out of bounds")
    buckets = sorted({blk.bucket for blk in fs.fleet._blocks})
    log(f"[fleet] launches {json.dumps(launches)}; MSO rounds over blocks "
        f"{delta['n_mso_rounds']}, fit evaluations {delta['n_fit_evals']}, "
        f"block programs {json.dumps(progs)}; programs "
        f"{snap['n_fleet_compiles']} over buckets {buckets} x slots "
        f"{c['slots']}; migrations {snap['n_migrations']}")
    check(launches["matern52_posterior_fwd"] == delta["n_mso_rounds"] > 0
          and launches["matern52_posterior_bwd_xq"]
          == delta["n_mso_rounds"],
          "fleet: K1/K2 launches != MSO rounds summed over blocks")
    check(launches["matern52_gram_bwd_theta"] == delta["n_fit_evals"] > 0,
          "fleet: K4 launches != fit evaluations")
    # K3: one a fit evaluation, one a full program's post-fit gram, one a
    # rank-one program's cross columns (all the block's slots at once)
    check(launches["matern52_gram_fwd"]
          == delta["n_fit_evals"] + progs["full"] + progs["incr"],
          "fleet: K3 launches != evaluations + full + rank-one programs")
    check(snap["n_fleet_compiles"] <= 3 * len(buckets),
          f"fleet: {snap['n_fleet_compiles']} programs for "
          f"{len(buckets)} (bucket, slots) shapes")
    check(len(buckets) == 2 and snap["n_migrations"] == S,
          f"fleet: buckets {buckets}, migrations {snap['n_migrations']}")
    wall = sum(r["ms"] for r in rows) / 1e3
    k = c["solo_rounds"]
    fleet_first = sum(r["ms"] for r in rows[:k]) / 1e3
    layers = fleet_layers(c, fs, state0, draws0, seeds0, xs[0])

    # the same studies solo, in turn: the throughput of the first rounds,
    # and each study's suggestions against its solo fused sampler's
    solo_s, worst = 0.0, [0.0] * k
    import torch
    for i in range(S):
        s = GPSampler(space, strategy="dbe_vec", seed=i, **fleet_kw(c))
        startup(s, obj, c["startup"])
        for r in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = s.ask()
            torch.cuda.synchronize()
            solo_s += time.perf_counter() - t0
            s.tell(t.trial_id, obj(t.x))
            worst[r] = max(worst[r], float(np.abs(
                space.to_unit(t.x) - space.to_unit(xs[r, i])).max()))
    log(f"[fleet] against each study's solo fused sampler (end to end, "
        f"{S} studies, rounds 1–{k}: full and rank-one refits, "
        f"{c['startup']} → {c['startup'] + k} trials across the bucket "
        f"boundary): max |Δx| in unit space by round "
        f"{', '.join(f'{w:.3e}' for w in worst)} (≤ 1e-10)")
    check(max(worst) <= 1e-10,
          f"fleet: a study's suggestions lie {max(worst)} from its solo "
          f"sampler's")
    from repro_torch.gp.fit import pad_bucket_for
    first = {kd for r in rows[:k] for kd in r["kinds"]}
    check({"full", "incremental"} <= first
          and pad_bucket_for(rows[0]["n"], c["pad"])
          < pad_bucket_for(rows[k - 1]["n"], c["pad"]),
          f"fleet: the solo comparison's rounds {rows[:k]} miss a kind of "
          f"refit or a bucket migration")
    thr = dict(fleet_suggests_per_s=S * c["rounds"] / wall,
               fleet_first_suggests_per_s=S * k / fleet_first,
               solo_first_suggests_per_s=S * k / solo_s,
               fleet_ms_per_round=1e3 * wall / c["rounds"],
               solo_ms_per_suggest=1e3 * solo_s / (S * k))
    thr["card"] = card()
    log("[fleet] throughput: " + json.dumps(thr))

    # one rank-one round and one full round (every rank-one update vetoed:
    # the fallback, a rank-one and a full program), traced
    traced = {"incremental": traced_round(fs, obj)}
    fs.fleet.fault_injector = VetoAll()
    traced["full"] = traced_round(fs, obj)
    fs.fleet.fault_injector = None
    for kind, row in traced.items():
        row["untraced_host_ms"] = float(np.median(
            [r["ms"] for r in rows if list(r["kinds"]) == [kind]]
            or [float("nan")]))
        row["card"] = card()
        log(f"[fleet] traced {kind} round: " + json.dumps(row))

    fleet_bits(dev, c)
    fleet_recovery(c)
    return dict(launches=launches, rounds=rows, throughput=thr,
                traced=traced, programs=snap["n_fleet_compiles"],
                solo_max_dx=max(worst), layers=layers)


# ------------------------------------------------ slice 6: the BO service
# The service phase's full-width traffic (the fleet phase's studies, split
# among three tenants: name, weight, studies [a, b), GP rounds) and its
# smaller fleets; a CPU rehearsal passes smaller ones.  The quantum covers
# every tenant's studies in one DRR round (6 × bronze's weight 1 ≥ its 6
# studies), so the service is uncontended and each fleet step serves every
# queued ask, as the direct drive does.  ``deadline`` (s, real clock) is
# shorter than a full fleet round; ``small`` sizes the ladder, NaN-trip and
# recovery fleets.
SERVICE = dict(D=20, slots=8, B=10, pad=32, refit_interval=8, startup=542,
               tenants=(("gold", 4.0, 0, 4, 2), ("silver", 2.0, 4, 10, 2),
                        ("bronze", 1.0, 10, 16, 1)),
               quantum=6.0, deadline=1.0,
               small=dict(D=5, B=10, pad=8, startup=6, rounds=12,
                          kill_at=85))


class VClock:
    """The phase's virtual clock (``now``/``sleep`` like ``time``'s, moved
    only by ``sleep`` and ``advance``): deadlines, backoff and the
    overload ladder's latencies become exact."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, float(dt))

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def timed(fn, rows):
    """``fn`` wrapped to append (host ms to a synchronize, its result) to
    ``rows`` at each call."""
    import torch

    def wrap(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t0) * 1e3, out))
        return out
    return wrap


def step_timer(step, rows, fleet_rows):
    """``svc.service_step`` wrapped to append (host ms, host ms of the
    fleet steps it made, suggestions they served) to ``rows`` for each
    call that reached a fleet step (``fleet_rows`` is fed by ``timed``
    around ``fleet.step``)."""
    import torch

    def wrap():
        k = len(fleet_rows)
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if len(fleet_rows) > k:
            rows.append((ms, sum(f for f, _ in fleet_rows[k:]),
                         sum(n for _, n in fleet_rows[k:])))
        return out
    return wrap


def recorded(fs, log_):
    """Log the fleet-level schedule a service drives (each ``ask_batch``'s
    studies, each ``tell``) so that a twin can replay it directly."""
    ask_batch, tell = fs.ask_batch, fs.tell

    def rec_ask(studies):
        studies = list(studies)
        log_.append(("ask", studies))
        return ask_batch(studies)

    def rec_tell(study, trial_id, y, **kw):
        log_.append(("tell", study, trial_id, y, kw))
        return tell(study, trial_id, y, **kw)
    fs.ask_batch, fs.tell = rec_ask, rec_tell


def replay(fs, events):
    """Drive a FleetSampler directly through a recorded schedule; returns
    the host ms of its ask_batch calls and tells."""
    import torch
    t0 = time.perf_counter()
    for ev in events:
        if ev[0] == "ask":
            out = fs.ask_batch(ev[1])
            check(not any(isinstance(t, Exception) for t in out),
                  f"direct drive: a study failed in {ev[1]}")
        else:
            fs.tell(ev[1], ev[2], ev[3], **ev[4])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def service_fleet(c, space, **kw):
    from repro_torch.bo.sampler import FleetSampler
    S = sum(b - a for _, _, a, b, _ in c["tenants"])
    return FleetSampler(space, n_studies=S, seed=0, slots=c["slots"],
                        **fleet_kw(c), **kw)


def service_tenants(c):
    from repro_torch.serve.bo_service import TenantConfig
    return [TenantConfig(name, weight=w, studies=tuple(range(a, b)))
            for name, w, a, b, _ in c["tenants"]]


def sync_round(svc, obj, studies):
    """One ask per study through the service's sync core, served, told."""
    owner = svc._study_owner
    reqs = [svc.submit_ask(owner[s], s) for s in studies]
    for _ in range(4):
        if all(r.done for r in reqs):
            break
        svc.service_step()
    check(all(r.done and r.result is not None for r in reqs),
          f"service: requests not served: {[r.state for r in reqs]}")
    for r in reqs:
        svc.submit_tell(r.tenant, r.study, r.result.trial_id,
                        obj(r.result.x))
    return reqs


async def tenants_drive(c, svc, obj, plan, shed=None):
    """The tenants as asyncio coroutines, one per study, beside the
    ``svc.run()`` server task: each asks, evaluates, tells, for the rounds
    ``plan`` ((tenant, study, rounds) rows) gives it.  With ``shed`` (a
    list), study 0's first ask carries c["deadline"], shorter than a full
    round: it is shed in flight (DeadlineExceeded, the one exception
    caught), recorded, and asked again.  Returns the host ms."""
    import asyncio
    from repro_torch.serve.bo_service import DeadlineExceeded

    async def study(name, s, rounds):
        for r in range(rounds):
            dl = c["deadline"] if shed is not None and (s, r) == (0, 0) \
                else None
            try:
                t = await svc.ask(name, s, deadline=dl)
            except DeadlineExceeded as e:
                check(dl is not None and "in flight" in str(e),
                      f"service: unexpected shed of study {s}: {e}")
                shed.append((s, str(e)))
                t = await svc.ask(name, s)
            check(dl is None or shed, "service: the deadline ask of "
                  "study 0 came back in time")
            await svc.tell(name, s, t.trial_id, obj(t.x))

    t0 = time.perf_counter()
    await asyncio.gather(*(study(name, s, r) for name, s, r in plan))
    return (time.perf_counter() - t0) * 1e3


def service_ladder(c):
    """The overload ladder under the phase's virtual clock on a small fleet
    on the card (D = c["small"]["D"], 4 studies, tenants A (weight 2,
    studies 0, 1) and B (weight 1, studies 2, 3)): the p99 rungs (window
    of one completion, SLO 1 s) walk admit → reject → degrade →
    shed_tenant as a backlog's latency grows, then de-escalate to admit.
    B's asks under degrade run the solo fused ask on the card: the step's
    launches are the fleet's identities plus each solo ask's own.  The
    quantum serves one ask of each study a round (A's deficit 4 covers
    study 0's backlog, B's 2 both its studies)."""
    import tempfile
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import FleetSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.engine.fleet import FleetFullError
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.serve.bo_service import (BOService, OverloadConfig,
                                              TenantConfig, TenantShedError)
    sm = c["small"]
    d = sm["D"]
    obj = make_objective("rastrigin", d)
    clock = VClock()
    with tempfile.TemporaryDirectory() as tmp:
        fs = FleetSampler(BoxSpace.cube(d, -5.0, 5.0), n_studies=4, seed=0,
                          slots=4, journal_dir=tmp, sleep_fn=clock.sleep,
                          n_startup_trials=sm["startup"], n_restarts=sm["B"],
                          pad_multiple=sm["pad"])
        svc = BOService(fs, [TenantConfig("A", weight=2.0, studies=(0, 1)),
                             TenantConfig("B", weight=1.0, studies=(2, 3))],
                        overload=OverloadConfig(
                            reject_depth=10 ** 6, degrade_depth=10 ** 6,
                            shed_depth=10 ** 6, p99_slo=1.0, window=1,
                            min_samples=1), quantum=2.0, clock=clock)
        for _ in range(sm["startup"] + 2):       # two GP rounds at admit
            sync_round(svc, obj, range(4))
        backlog = [svc.submit_ask("A", 0) for _ in range(4)]
        b_reqs = [svc.submit_ask("B", s) for _ in range(5) for s in (2, 3)]
        rungs, solo, launches = [], [], dict.fromkeys(K.LAUNCHES, 0)
        want = dict.fromkeys(K.LAUNCHES, 0)
        for step in range(6):
            clock.advance(1.5 if step == 0 else 1.0)
            snap0 = fs.fleet.stats_snapshot()
            before = K.launch_counts()
            svc.service_step()
            after = K.launch_counts()
            snap = fs.fleet.stats_snapshot()
            rung = svc.stats_snapshot()["svc_rung"]
            rungs.append(rung)
            if rung == "reject":
                try:                             # the rung refuses asks
                    svc.submit_ask("A", 1)
                    fail("service ladder: an ask was admitted at reject")
                except FleetFullError as e:
                    check("rung reject" in str(e), f"ladder: {e}")
            if rung == "degrade":
                dm = snap["n_mso_rounds"] - snap0["n_mso_rounds"]
                df = snap["n_fit_evals"] - snap0["n_fit_evals"]
                dp = {k: snap["n_block_programs"][k]
                      - snap0["n_block_programs"][k] for k in ("full",
                                                                "incr")}
                exp = {"matern52_posterior_fwd": dm,
                       "matern52_posterior_bwd_xq": dm,
                       "matern52_gram_fwd": df + dp["full"] + dp["incr"],
                       "matern52_gram_bwd_theta": df}
                for s in (2, 3):
                    info = fs.samplers[s].last_ask_info
                    check(fs.samplers[s]._fleet is None
                          and fs.samplers[s]._ask is not None,
                          f"ladder: degraded study {s} not on the solo ask")
                    solo.append(info.rounds)
                    for k, v in expected_launches(info).items():
                        exp[k] += v
                for k in K.LAUNCHES:
                    d_ = after.get(k, 0) - before.get(k, 0)
                    launches[k] += d_
                    want[k] += exp.get(k, 0)
        recs = fs.journal.replay()
        moves = [(r["from"], r["rung"]) for r in recs
                 if r["op"] == "svc_overload"]
    snap = svc.stats_snapshot()
    t = snap["svc_tenants"]
    log(f"[service] ladder: rungs by step {rungs}; journaled {moves}; "
        f"B's solo asks under degrade {len(solo)} ({sum(solo)} MSO rounds); "
        f"launches under degrade {json.dumps(launches)}")
    check(moves == [("admit", "reject"), ("reject", "degrade"),
                    ("degrade", "shed_tenant"), ("shed_tenant", "admit")],
          f"service ladder: transitions {moves}")
    check(launches == want and launches["matern52_posterior_fwd"]
          > sum(solo) > 0,
          f"service ladder: launches {launches} != fleet identities + the "
          f"solo asks' own {want}")
    check(rungs[-1] == "admit"
          and all(r.result is not None for r in backlog)
          and t["B"]["is_shed"] and t["B"]["degraded"]
          and not t["A"]["is_shed"] and not t["A"]["degraded"]
          and sum(isinstance(r.error, TenantShedError) for r in b_reqs) == 2
          and sum(r.result is not None for r in b_reqs) == 8,
          f"service ladder: tenants {t}")
    return dict(moves=moves, solo_asks=len(solo), solo_rounds=sum(solo),
                launches=launches)


def service_nan_trip(c):
    """A NaN put into one block's observations on a small fleet with the
    guard installed: NonFiniteError naming the program and the leaf,
    after the ``nan_guard.nonfinite`` instant."""
    from repro_torch.analysis import NonFiniteError, install_nan_guard
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import FleetSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.obs import trace as obs
    sm = c["small"]
    obj = make_objective("rastrigin", sm["D"])
    fs = FleetSampler(BoxSpace.cube(sm["D"], -5.0, 5.0), n_studies=2,
                      seed=0, slots=2, n_startup_trials=sm["startup"],
                      n_restarts=sm["B"], pad_multiple=sm["pad"])
    install_nan_guard(fs.fleet)
    startup(fs, obj, sm["startup"] + 2)
    fs.fleet._blocks[0].y[1, 0] = float("nan")
    tr = obs.enable()
    try:
        fs.ask_all()
        fail("NaN guard: a poisoned block passed the guard")
    except NonFiniteError as e:
        msg = str(e)
    evs = [e for e in tr.events() if e["name"] == "nan_guard.nonfinite"]
    obs.disable()
    check(len(evs) == 1 and evs[0]["args"]["leaf"] == "[0][1]"
          and f"'{evs[0]['args']['program']}' at leaf [0][1]" in msg,
          f"NaN guard: {msg}; instants {evs}")
    log(f"[service] NaN guard trip: {msg[:96]}...; instant "
        f"{json.dumps(evs[0]['args'])}")
    return evs[0]["args"]


def service_recovery(c):
    """A 2-tenant service on a small fleet (refit_interval=1) killed at a
    journal offset and recovered with ``BOService.recover`` (the card by
    default): the pending queue comes back in rid order and every later
    suggestion is bitwise the uninterrupted run's."""
    import tempfile
    import numpy as np
    from repro_torch.bo.journal import InjectedCrash
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.sampler import FleetSampler
    from repro_torch.bo.space import BoxSpace
    from repro_torch.serve.bo_service import BOService, TenantConfig
    sm = c["small"]
    d, rounds = sm["D"], sm["rounds"]
    obj = make_objective("rastrigin", d)
    space = BoxSpace.cube(d, -5.0, 5.0)
    tenants = [TenantConfig("a", weight=2.0, studies=(0,)),
               TenantConfig("b", weight=1.0, studies=(1,))]
    kw = dict(n_startup_trials=sm["startup"], n_restarts=sm["B"],
              pad_multiple=sm["pad"], slots=2, refit_interval=1,
              warm_start=False)

    def script(svc, n):
        for r in range(n):
            if r == 7 and svc.fs.ckpt is not None:
                svc.fs.checkpoint()
            sync_round(svc, obj, (0, 1))

    clock = VClock()
    ref = BOService(FleetSampler([space] * 2, seed=0, sleep_fn=clock.sleep,
                                 **kw), tenants, clock=clock)
    script(ref, rounds)
    with tempfile.TemporaryDirectory() as tmp:
        clock = VClock()
        vic = BOService(FleetSampler([space] * 2, seed=0, journal_dir=tmp,
                                     fault_injector=KillAt(sm["kill_at"]),
                                     sleep_fn=clock.sleep, **kw),
                        tenants, clock=clock)
        try:
            script(vic, rounds)
            fail("service recovery: the injected kill did not fire")
        except InjectedCrash:
            pass
        svc, rep = BOService.recover(tmp, clock=VClock())
        check(svc.fs.fleet.device.type == "cuda",
              "service recovery: not on the card")
        queued = svc.recovered["queued"]
        ready = svc.recovered["ready"]
        rids = [r.rid for r in queued]
        check(rids == sorted(rids), f"service recovery: queue {rids}")
        for i, tid in rep.pending:
            svc.submit_tell(svc._study_owner[i], i, tid,
                            obj(svc.fs.samplers[i].trials[tid].x))
        for _ in range(4):
            if all(r.done for r in queued):
                break
            svc.service_step()
        for r in queued:
            check(r.result is not None, "service recovery: queue unserved")
            svc.submit_tell(r.tenant, r.study, r.result.trial_id,
                            obj(r.result.x))
        while min(len(s.trials) for s in svc.fs.samplers) < rounds:
            sync_round(svc, obj, [i for i in range(2)
                                  if len(svc.fs.samplers[i].trials)
                                  < rounds])
    for i in range(2):
        a, b = ref.fs.samplers[i].trials, svc.fs.samplers[i].trials
        check(len(b) >= rounds, "service recovery: too few trials")
        for ta, tb in zip(a, b[:rounds]):
            check(np.array_equal(ta.x, tb.x),
                  f"service recovery: study {i} trial {ta.trial_id} "
                  f"differs")
    log(f"[service] recovery: killed at journal seq {sm['kill_at']} "
        f"({rep.n_records} records, {rep.truncated_bytes} torn bytes); "
        f"restored queue {[(r.rid, r.tenant, r.study) for r in queued]}, "
        f"ready {[(r.rid, r.study) for r in ready]}, pending "
        f"{rep.pending}; D={d}, {rounds} rounds: both studies bitwise the "
        f"uninterrupted run")
    return dict(queued=len(queued), ready=len(ready))


def service_overhead_cli():
    """``python -m repro_torch.obs overhead`` on this host: the disabled
    tracer's ns per call against its 5 µs budget."""
    run = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "overhead"], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    check(run.returncode == 0, f"obs overhead: {run.stdout} {run.stderr}")
    log(f"[service] {run.stdout.strip()}; {card()}")
    return run.stdout.strip()


def quantiles_ms(lat):
    import numpy as np
    if not lat:
        return None, None
    a = 1e3 * np.asarray(lat)
    return float(np.quantile(a, 0.5)), float(np.quantile(a, 0.99))


def phase_service(dev, c=SERVICE):
    """BOService over the fleet at full width, three tenants as asyncio
    coroutines beside ``svc.run()`` on the real clock, in one session:
    the GP rounds (launch identities, the deadline shed in flight), one
    traced round, one guarded round; then the direct drive of the same
    schedule bitwise, schema, exposition and the journal's timeline; then
    the ladder, NaN-trip and recovery checks on small fleets."""
    import asyncio
    import tempfile
    import numpy as np
    import torch
    from repro_torch.analysis import install_nan_guard, nan_guard_stats
    from repro_torch.bo.objectives import make_objective
    from repro_torch.bo.space import BoxSpace
    from repro_torch.kernels.matern import kernel as K
    from repro_torch.obs import export, metrics
    from repro_torch.obs import trace as obs
    from repro_torch.serve.bo_service import BOService

    D = c["D"]
    obj = make_objective("rastrigin", D)
    space = BoxSpace.cube(D, -5.0, 5.0)
    tenants = service_tenants(c)
    S = sum(len(t.studies) for t in tenants)
    tmp = tempfile.TemporaryDirectory()
    jdir, tdir = (os.path.join(tmp.name, n) for n in ("svc", "twin"))
    fs = service_fleet(c, space, journal_dir=jdir)
    check(fs.fleet.cfg.backend == "fused", "service fleet not fused")
    svc = BOService(fs, tenants, quantum=c["quantum"])
    events, steps, fleet_steps = [], [], []
    recorded(fs, events)
    fs.fleet.step = timed(fs.fleet.step, fleet_steps)
    svc.service_step = step_timer(svc.service_step, steps, fleet_steps)

    # random startup through the sync core, the journal's fsync off (it
    # is on again, as deployed, for the GP rounds measured below)
    fs.journal.sync = False
    t0 = time.perf_counter()
    for _ in range(c["startup"]):
        sync_round(svc, obj, range(S))
    startup_s = time.perf_counter() - t0
    fs.journal.sync = True
    n_start = len(steps)
    lat0 = {t.name: len(svc.tenant_latencies(t.name)) for t in tenants}
    served0 = svc.stats_snapshot()["svc_tenants"]
    out = {}

    async def session():
        server = asyncio.create_task(svc.run())
        # the GP rounds, each tenant its own number
        out["snap0"] = fs.fleet.stats_snapshot()
        out["n_ev0"] = len(events)
        out["n_steps0"] = len(steps)
        shed = out["shed"] = []
        K.reset_launch_counts()
        out["wall_ms"] = await tenants_drive(
            c, svc, obj, [(name, s, r) for name, _, a, b, r in c["tenants"]
                          for s in range(a, b)], shed)
        out["launches"] = K.launch_counts()
        out["snap"] = fs.fleet.stats_snapshot()
        out["ssnap"] = svc.stats_snapshot()
        out["n_ev1"] = len(events)
        out["n_steps1"] = len(steps)
        # one traced round, every study (rank-one refits): obs spans, and
        # the card's busy time beside the host's
        plan = [(t.name, s, 1) for t in tenants for s in t.studies]
        tr = obs.enable()
        with card_trace() as prof:
            out["traced_ms"] = await tenants_drive(c, svc, obj, plan)
            torch.cuda.synchronize()
        out["obs_events"] = tr.events()
        obs.disable()
        out["prof"] = prof
        out["compiles_traced"] = fs.fleet.stats_snapshot()[
            "n_fleet_compiles"]
        # one guarded round (bronze's rank-one round on its block)
        before = fs.stats_snapshot()
        guards = list(install_nan_guard(fs.fleet))
        check(fs.stats_snapshot() == before,
              "NaN guard changed the snapshot")
        spent = out["guard_spent"] = []
        for g in guards:
            g._check = timed(g._check, spent)
        out["guard_before"] = before
        out["guard_ms"] = await tenants_drive(
            c, svc, obj, [(tenants[-1].name, s, 1)
                          for s in tenants[-1].studies])
        out["guard_after"] = fs.stats_snapshot()
        svc.stop()
        await server

    asyncio.run(session())

    launches, snap0, snap, ssnap = (out[k] for k in ("launches", "snap0",
                                                      "snap", "ssnap"))
    shed, wall_ms, n_ev0 = out["shed"], out["wall_ms"], out["n_ev0"]
    delta = {k: snap[k] - snap0[k] for k in ("n_mso_rounds", "n_fit_evals")}
    progs = {k: snap["n_block_programs"][k] - snap0["n_block_programs"][k]
             for k in ("full", "incr", "mso")}
    n_gp = ssnap["svc_completed"] - sum(v["served"]
                                        for v in served0.values())
    buckets = sorted({blk.bucket for blk in fs.fleet._blocks})
    log(f"[service] GP rounds: {n_gp} asks served in {wall_ms:.1f} ms, "
        f"shed {shed}; launches {json.dumps(launches)}; MSO rounds "
        f"{delta['n_mso_rounds']}, fit evaluations {delta['n_fit_evals']}, "
        f"block programs {json.dumps(progs)}; programs "
        f"{snap['n_fleet_compiles']} over buckets {buckets}")
    svc_keys = {k: v for k, v in ssnap.items()
                if k.startswith("svc_") and k != "svc_tenants"}
    check(len(shed) == 1 and ssnap["svc_shed"] == 1
          and ssnap["svc_deadline_miss"] == 1 and ssnap["svc_rejected"] == 0
          and ssnap["svc_rung"] == "admit" and ssnap["svc_rung_changes"] == 0
          and ssnap["svc_queue_depth"] == 0
          and n_gp == sum((b - a) * r for _, _, a, b, r in c["tenants"]),
          f"service: served {n_gp}, {json.dumps(svc_keys)}")
    check(launches["matern52_posterior_fwd"] == delta["n_mso_rounds"] > 0
          and launches["matern52_posterior_bwd_xq"]
          == delta["n_mso_rounds"],
          "service: K1/K2 launches != MSO rounds summed over blocks")
    check(launches["matern52_gram_bwd_theta"] == delta["n_fit_evals"] > 0,
          "service: K4 launches != fit evaluations")
    check(launches["matern52_gram_fwd"]
          == delta["n_fit_evals"] + progs["full"] + progs["incr"],
          "service: K3 launches != evaluations + full + rank-one programs")
    check(snap["n_fleet_compiles"] <= 3 * len(buckets),
          f"service: {snap['n_fleet_compiles']} programs for {buckets}")
    errs = metrics.validate_snapshot("bo_service", ssnap)
    check(errs == [], f"service: snapshot schema {errs}")
    # the deadline shed: journaled in flight, its trial left pending
    recs = [r for r in fs.journal.replay() if r["op"] == "svc_shed"]
    check(len(recs) == 1 and recs[0]["reason"] == "deadline exceeded in "
          "flight" and fs.samplers[0].trials[c["startup"]].state
          == "pending", f"service: deadline shed records {recs}")

    # the same studies driven directly through the GP rounds' schedule
    twin = service_fleet(c, space, journal_dir=tdir)
    twin.journal.sync = False
    replay(twin, events[:n_ev0])
    twin.journal.sync = True
    twin_ms = replay(twin, events[n_ev0:out["n_ev1"]])
    n_twin = {i: len(s.trials) for i, s in enumerate(twin.samplers)}
    worst = 0
    for i, (a, b) in enumerate(zip(fs.samplers, twin.samplers)):
        mine = a.trials[:n_twin[i]]
        check(len(b.trials) > c["startup"]
              and [t.state for t in mine[:-1]]
              == [t.state for t in b.trials[:-1]],
              "service: the direct drive's trials differ in number or state")
        worst += sum(not np.array_equal(ta.x, tb.x)
                     for ta, tb in zip(mine, b.trials))
    gp_batches = [e[1] for e in events[n_ev0:out["n_ev1"]] if e[0] == "ask"]
    tsnap = twin.fleet.stats_snapshot()
    log(f"[service] direct drive of the same schedule ({len(gp_batches)} "
        f"batches: {[len(b) for b in gp_batches]} studies; full, rank-one "
        f"and the deadline's resubmission): {worst} suggestions differ "
        f"(bitwise required); programs {tsnap['n_fleet_compiles']}")
    check(worst == 0, f"service: {worst} suggestions differ from the direct "
          f"drive's")
    check(progs["full"] > 0 and progs["incr"] > 0
          and tsnap["n_block_programs"] == snap["n_block_programs"],
          f"service: block programs {snap['n_block_programs']} vs the "
          f"direct drive's {tsnap['n_block_programs']}")

    # host ms a service_step beyond its fleet.step: GP steps (the fleet
    # served) and startup steps (it had nothing to run); idle polls of
    # svc.run(), which reach no fleet step, are left out
    gp = [w - f for w, f, served in steps[out["n_steps0"]:out["n_steps1"]]
          if served]
    st = [w - f for w, f, _ in steps[:n_start]]
    lat = {t.name: svc.tenant_latencies(t.name)[lat0[t.name]:][
        :ssnap["svc_tenants"][t.name]["served"] - served0[t.name]["served"]]
        for t in tenants}
    shares = {}
    for t in tenants:
        p50, p99 = quantiles_ms(lat[t.name])
        shares[t.name] = dict(
            weight=t.weight, weight_share=t.weight / sum(
                u.weight for u in tenants),
            served=len(lat[t.name]), served_share=len(lat[t.name]) / n_gp,
            ask_p50_ms=p50, ask_p99_ms=p99)
    thr = dict(service_suggests_per_s=n_gp / (wall_ms / 1e3),
               direct_suggests_per_s=n_gp / (twin_ms / 1e3),
               service_ms=wall_ms, direct_ms=twin_ms,
               service_steps=len(gp), service_step_host_ms_beyond_fleet=dict(
                   median=float(np.median(gp)), max=float(np.max(gp))),
               startup_steps=len(st), startup_step_host_ms=dict(
                   median=float(np.median(st)), max=float(np.max(st))),
               startup_s=startup_s, tenants=shares, card=card())
    log("[service] throughput: " + json.dumps(thr))

    # the traced round: a Chrome trace with svc.* and fleet.* spans
    bd = export.phase_breakdown(out["obs_events"])
    ct = export.chrome_trace(out["obs_events"], "chip_smoke service")
    dev_us = device_breakdown(out["prof"])
    busy = sum(dev_us.values()) / 1e3
    row = dict(host_ms=out["traced_ms"], device_ms=busy,
               device_idle_share=1.0 - busy / out["traced_ms"],
               device_ms_by_class={k: v / 1e3 for k, v in dev_us.items()},
               spans={k: v for k, v in bd.items()
                      if k.startswith(("svc.", "fleet."))}, card=card())
    log("[service] traced round: " + json.dumps(row))
    check(export.validate_chrome_trace(ct) == [] and busy > 0
          and {"svc.drr_round", "svc.dispatch", "fleet.ask_batch",
               "fleet.step"} <= set(bd),
          f"service: traced round spans {sorted(bd)}")
    check(out["compiles_traced"] == snap["n_fleet_compiles"]
          == tsnap["n_fleet_compiles"],
          f"service: programs {snap['n_fleet_compiles']} → "
          f"{out['compiles_traced']} with the tracer on, "
          f"{tsnap['n_fleet_compiles']} untraced")

    # the guarded round: one check a program call, no trip, no program
    before, after = out["guard_before"], out["guard_after"]
    calls = (sum(after["n_block_programs"].values())
             - sum(before["n_block_programs"].values()))
    gst = nan_guard_stats(fs.fleet)
    guard = dict(program_calls=calls, guard_checks=gst["n_guard_checks"],
                 guard_ms=sum(ms for ms, _ in out["guard_spent"]),
                 round_ms=out["guard_ms"], card=card())
    log("[service] guarded round: " + json.dumps(guard))
    check(gst["installed"] and gst["n_guard_checks"] == calls > 0
          and after["n_fleet_compiles"] == snap["n_fleet_compiles"],
          f"NaN guard: {gst} over {calls} program calls, programs "
          f"{after['n_fleet_compiles']}")

    # the Prometheus scrape, and the WAL timeline of the whole journal
    final = svc.stats_snapshot()
    reg = metrics.MetricsRegistry()
    metrics.ingest_snapshot(reg, "bo_service", final)
    text = reg.render_prometheus()
    for t in tenants:
        served = float(final["svc_tenants"][t.name]["served"])
        check(f'repro_tenant_served{{component="bo_service",tenant='
              f'"{t.name}"}} {served:g}' in text,
              f"service: exposition lacks tenant {t.name}")
    tl = export.timeline_from_journal(jdir)
    check(export.validate_chrome_trace(tl) == []
          and tl["otherData"]["n_records"] == fs.journal.seq,
          "service: the journal's timeline does not validate")
    spans = [e for e in tl["traceEvents"] if e["ph"] == "X"]
    log(f"[service] exposition {len(text.splitlines())} lines, per-tenant "
        f"gauges; timeline of {tl['otherData']['n_records']} journal "
        f"records: {len(tl['traceEvents'])} events, {len(spans)} request "
        f"spans, valid")
    fs.journal.close()
    twin.journal.close()
    tmp.cleanup()

    cli = service_overhead_cli()
    ladder = service_ladder(c)
    trip = service_nan_trip(c)
    rec = service_recovery(c)
    return dict(launches=launches, throughput=thr, traced=row, guard=guard,
                ladder=ladder, nan_trip=trip, recovery=rec, overhead=cli)


# ------------------------------------------------------------ slice 9
# K7 (flash_attention_bwd) cases: (tag, B, Sq, Sk, NH, KH, hd, dtype,
# causal, window in the Pallas rule, query positions): "self" is
# arange(S) for queries and keys, "zero" puts every query at 0 (whisper's
# cross-attention); every attention a family's training runs
TRAIN_K7 = (
    ("slice: llama3.2-3b B=4 S=512", 4, 512, 512, 24, 8, 128, "bfloat16",
     True, None, "self"),
    ("f32 hd 64 ragged S=300 window 128", 2, 300, 300, 4, 2, 64, "float32",
     True, 128, "self"),
    ("qwen3 heads G=8 S=256", 2, 256, 256, 32, 4, 128, "bfloat16", True,
     None, "self"),
    ("recurrentgemma NH=16 KH=1 hd 256 window 2048 S=2560", 1, 2560, 2560,
     16, 1, 256, "bfloat16", True, 2048, "self"),
    ("whisper encoder B=2 S=1500 not causal", 2, 1500, 1500, 8, 8, 64,
     "bfloat16", False, None, "self"),
    ("whisper cross Sq=64 over 1500", 2, 64, 1500, 8, 8, 64, "bfloat16",
     False, None, "zero"),
    ("no visible key: window 0, causal", 2, 96, 96, 4, 2, 64, "float32",
     True, 0, "self"),
    # slice 10: K7's MMA path at a ragged tile with a window, and with
    # nothing visible
    ("bf16 hd 128 ragged S=300 window 128 G=3", 2, 300, 300, 6, 2, 128,
     "bfloat16", True, 128, "self"),
    ("bf16 hd 64 no visible key: window 0, causal", 2, 96, 96, 4, 2, 64,
     "bfloat16", True, 0, "self"),
)
K7_F32_TOL = 1e-4


def train_k7_inputs(dev, case, seed):
    """q, k, v, dO, q_pos, kv_pos of a TRAIN_K7 case (normal draws)."""
    import torch
    _, b, sq, sk, nh, kh, hd, dtype, _, _, qpos = case
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dt)
                   for sh in ((b, sq, nh, hd), (b, sk, kh, hd),
                              (b, sk, kh, hd), (b, sq, nh, hd)))
    kp = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk)
    qp = (torch.arange(sq, dtype=torch.int32, device=dev).expand(b, sq)
          if qpos == "self" else
          torch.zeros((b, sq), dtype=torch.int32, device=dev))
    return q, k, v, do, qp.contiguous(), kp.contiguous()


def k7_err(got, ref):
    """(max |Δ|, within the limit) of one gradient: both sum in float32 in
    other orders, so |Δ| ≤ K7_F32_TOL · max|ref| (a norm-wise limit: a
    gradient entry sums up to Sq·G or Sk terms), plus one rounding of the
    entry to bf16 (2⁻⁷·|ref|) for bf16 inputs."""
    import torch
    d = (got.float() - ref.float()).abs()
    lim = K7_F32_TOL * float(ref.float().abs().max()) + (
        2.0 ** -7 * ref.float().abs() if ref.dtype == torch.bfloat16 else 0.0)
    return float(d.max()), bool((d <= lim).all())


def check_k7(dev, case, seed, err):
    """K6 with lse and K7 against their plain versions on one TRAIN_K7
    case: lse within 1e-4, K6's output bits the same with and without
    lse, K7's gradients within k7_err's limit and bitwise from run to run,
    exact zeros for rows (and keys) no pair sees."""
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,
                                               flash_attention_fwd_ref,
                                               position_mask)
    tag, causal, window = case[0], case[8], case[9]
    q, k, v, do, qp, kp = train_k7_inputs(dev, case, seed)
    kw = dict(causal=causal, window=window)
    out, lse = FK.flash_attention_fwd(q, k, v, qp, kp, return_lse=True, **kw)
    bare = FK.flash_attention_fwd(q, k, v, qp, kp, **kw)
    _, lse_ref = flash_attention_fwd_ref(q, k, v, qp, kp, return_lse=True,
                                         **kw)
    grads = FK.flash_attention_bwd(q, k, v, out, lse, do, qp, kp, **kw)
    again = FK.flash_attention_bwd(q, k, v, out, lse, do, qp, kp, **kw)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, do, qp, kp, **kw)
    torch.cuda.synchronize()
    check(torch.equal(out, bare), f"{tag}: K6's output bits move with lse")
    seen = position_mask(qp, kp, causal, window)                # (B, Sq, Sk)
    rows, keys = seen.any(-1), seen.any(1)
    fin = torch.isfinite(lse_ref)
    check(torch.equal(fin, torch.isfinite(lse)) and
          bool((lse[~fin] == torch.inf).all()),
          f"{tag}: lse's +inf rows differ from the plain version's")
    e_lse = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    check(e_lse <= 1e-4, f"{tag}: lse |Δ| {e_lse}")
    es = []
    for name, got, ref, rep in zip(("dq", "dk", "dv"), grads, refs, again):
        e, ok = k7_err(got, ref)
        check(ok, f"{tag}: K7 {name} |Δ| {e} over its limit")
        check(torch.equal(got, rep), f"{tag}: K7 {name} not bitwise from "
              f"run to run")
        check(bool(torch.isfinite(got.float()).all()), f"{tag}: K7 {name} "
              f"not finite")
        es.append(e)
    check(not bool(grads[0][~rows].any()), f"{tag}: a row with no visible "
          f"key has a nonzero dQ")
    check(not bool(grads[1][~keys].any()) and
          not bool(grads[2][~keys].any()),
          f"{tag}: a key no row sees has a nonzero dK or dV")
    err["flash_bwd"] = max(err.get("flash_bwd", 0.0), *es)
    err["flash_lse"] = max(err.get("flash_lse", 0.0), e_lse)
    log(f"[train kernels] {tag} ({FK.plan_of(q, k)[0]} forward, "
        f"{FK.bwd_plan_of(q, k)} backward): K7 |Δ| dq "
        f"{es[0]:.3e} dk {es[1]:.3e} dv {es[2]:.3e}, lse {e_lse:.3e}, "
        f"bitwise run to run; K6 bits unchanged with lse; "
        f"{int((~rows).sum())} rows and {int((~keys).sum())} keys unseen "
        f"= 0")
    return q, k, v, do, qp, kp, out, lse


def k7_timing(q, k, v, do, qp, kp, out, lse, causal, window):
    """Device and call ms of K7, its plain version and SDPA's backward
    (timed only, never on the path; with a window, SDPA takes the mask) on
    one case's tensors, K7's bound and its kernels' µs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,
                                               position_mask)
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    mask = (None if window is None else
            position_mask(qp, kp, causal, window)[:, None])
    so = F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    dos = do.transpose(1, 2)
    kw = dict(causal=causal, window=window)
    calls = {
        "flash_bwd": lambda: FK.flash_attention_bwd(
            q, k, v, out, lse, do, qp, kp, **kw),
        "flash_bwd_plain": lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, do, qp, kp, **kw),
        "sdpa_bwd": lambda: torch.autograd.grad(so, (qs, ks, vs), dos,
                                                retain_graph=True)}
    row = dict(flash_bwd_plan=FK.bwd_plan_of(q, k))
    for key, fn in calls.items():
        row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, 10)
        row[f"{key}_call_ms"] = cuda_time_ms(fn, 10)
    row["flash_bwd_bound_ms"], row["flash_bwd_bound_by"] = flash_bound_ms(
        *flash_bwd_cost(q, k, qp, kp, **kw))
    row["flash_bwd_kernels"] = kernel_us(calls["flash_bwd"], "flash_bwd_")
    return row


def phase_train_kernels(dev, err):
    """Slices 9–10's kernels: K6 with its log-sum-exp and K7 at every
    TRAIN_K7 case (check_k7, with each case's backward plan); then at the
    slice's shape (B=4, S=512, NH=24, KH=8, hd=128, bf16, causal: the
    MMA path) the device and call ms of K6 with and without lse, K7,
    their plain versions and SDPA's forward and backward (timed only,
    never on the path) beside their bounds, and K7 at whisper's encoder
    shape (B=2, S=1500, NH=KH=8, hd=64, not causal) beside SDPA's
    backward.  Returns the timing row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash.ref import flash_attention_fwd_ref
    t0 = time.perf_counter()
    whisper = None
    for i, case in enumerate(TRAIN_K7[1:]):
        got = check_k7(dev, case, 200 + i, err)
        if case[0].startswith("whisper encoder"):
            whisper = dict(shape=case[0] + " NH=KH=8 hd=64 bf16",
                           **k7_timing(*got, causal=case[8],
                                       window=case[9]))
        del got
        torch.cuda.empty_cache()
    q, k, v, do, qp, kp, out, lse = check_k7(dev, TRAIN_K7[0], 199, err)
    check(FK.bwd_plan_of(q, k) == "mma", f"K7 at the slice's shape takes "
          f"the {FK.bwd_plan_of(q, k)} path, not the MMA path")
    calls = {
        "flash": lambda: FK.flash_attention_fwd(q, k, v, qp, kp),
        "flash_lse": lambda: FK.flash_attention_fwd(q, k, v, qp, kp,
                                                    return_lse=True),
        "flash_lse_plain": lambda: flash_attention_fwd_ref(
            q, k, v, qp, kp, return_lse=True),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)}
    row = dict(shape=TRAIN_K7[0][0] + " NH=24 KH=8 hd=128 bf16 causal",
               plan=list(FK.plan_of(q, k)))
    for key, fn in calls.items():
        row[f"{key}_ms"], row[f"{key}_ms_from"] = device_ms(fn, 10)
        row[f"{key}_call_ms"] = cuda_time_ms(fn, 10)
    nbytes, ops, rate = flash_cost(q, k, qp, kp)
    row["flash_lse_bound_ms"], row["flash_lse_bound_by"] = flash_bound_ms(
        nbytes + 4 * lse.numel(), ops, rate)
    row.update(k7_timing(q, k, v, do, qp, kp, out, lse, causal=True,
                         window=TRAIN_K7[0][9]))
    row["whisper_bwd"] = whisper
    log("[timing] " + json.dumps(on_card(row)))
    log(f"[time] train kernels: {time.perf_counter() - t0:.1f} s")
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return row


# slice 9's training run: llama3.2-3b at full width, B=4, S=512, bf16
# remat "none", the setting of this row's earlier readings (taken before
# the port had remat), so they stay comparable; TRAIN_REMAT below runs
# B=8 under full remat
TRAIN = dict(arch="llama3.2-3b", batch=4, seq=512, steps=8, traced=3,
             lr=3e-4, weight_decay=0.1, layers=28, remat="none")
# the six families' reduced configs, card against CPU (f32)
TRAIN_FAMILIES = ("llama3.2-3b", "qwen3-moe-30b-a3b", "chameleon-34b",
                  "recurrentgemma-9b", "xlstm-1.3b", "whisper-base")
TRAIN_REL = 1e-5        # loss and grad norm, card against CPU
TRAIN_MU_REL = 1e-4     # first moment, |Δ| / max|·| per leaf
TRAIN_STEP_FRACTION = 0.5   # parameters: |Δ| ≤ this · lr


def train_opt(c=TRAIN, **kw):
    from repro_torch.train.optim import OptimConfig
    return OptimConfig(lr=c["lr"], weight_decay=c["weight_decay"],
                       total_steps=c["steps"], warmup_steps=1, **kw)


def train_device_ms(prof):
    """Device ms of one trace by class: K6 (flash_fwd_*), K7
    (flash_bwd_*), the matrix products (cuBLAS, by name), the rest, and
    all of it."""
    out = dict(k6=0.0, k7=0.0, cublas=0.0, other=0.0, busy=0.0)
    for ev in prof.key_averages():
        us = _device_us(ev)
        if us <= 0:
            continue
        key = ev.key.lower()
        cls = ("k6" if "flash_fwd" in key else "k7" if "flash_bwd" in key
               else "cublas" if any(k in key for k in GEMM_KEYS) else "other")
        out[cls] += us / 1e3
        out["busy"] += us / 1e3
    return out


def k6_runs(cfg) -> int:
    """K6 launches an attention layer takes in a train step: 1, and 2
    under remat (the layer's forward runs again in the backward)."""
    return 1 if cfg.remat == "none" else 2


def train_full_width(dev, c=TRAIN):
    """llama3.2-3b at full width through the port's train step under
    ``c["remat"]``: random weights drawn once on the card (seed 0,
    stacked: one leaf per reference leaf), DataConfig(B, S, seed 0),
    AdamW (lr 3e-4, wd 0.1, 8 total steps, 1 of warmup); ``steps`` steps
    with every count reset before them: finite loss and grad norm at
    each, the last loss below the first, K7 = 28 launches a step and K6
    28 (remat "none") or 56; then ``traced`` steps in a
    card_trace (K6, K7, cuBLAS, other and busy device ms a step, the idle
    share against the untraced steps' median host ms); then the step's
    halves apart (CUDA events): ``compute_grads`` and ``apply_updates``.
    Returns the row and the launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synth import DataConfig, synth_batch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.launch.shapes import init_fn_for
    from repro_torch.models.config import param_counts
    from repro_torch.train.optim import (apply_updates, init_opt_state,
                                         tree_leaves)
    from repro_torch.train.step import compute_grads, make_train_step
    t0 = time.perf_counter()
    cfg = get_config(c["arch"]).replace(remat=c["remat"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_fn_for(cfg)(cfg, torch.Generator(device=dev).manual_seed(0),
                              stacked=True)
    opt_cfg = train_opt(c)
    state = init_opt_state(params, opt_cfg)
    leaves = tree_leaves(params)
    numel = sum(p.numel() for p in leaves)
    check(numel == expected_params(cfg), f"train: {numel} parameters, want "
          f"{expected_params(cfg)}")
    # MFU counts the matrices (param_counts: 3,606,577,152), not the norms
    n_mfu = param_counts(cfg)["total"]
    check(all(p.dtype == torch.bfloat16 for p in leaves) and
          all(m.dtype == torch.float32 and m.shape == p.shape
              for m, p in zip(tree_leaves(state.mu) + tree_leaves(state.nu),
                              leaves + leaves)) and
          state.step.dtype == torch.int32 and len(leaves) == 12,
          "train: parameter or moment dtypes differ from the reference's")
    dcfg = DataConfig(global_batch=c["batch"], seq_len=c["seq"], seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in synth_batch(cfg, dcfg, i).items()}
               for i in range(c["steps"] + c["traced"])]
    step_fn = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    FK.reset_launch_counts()
    losses, gnorms, wall = [], [], []
    for i in range(c["steps"]):
        t1 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[i])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = FK.launch_counts()
    want = c["layers"] * c["steps"]
    check(launches == {"flash_attention_fwd": k6_runs(cfg) * want,
                       "flash_attention_bwd": want},
          f"train (remat {cfg.remat}): launches {launches}, want K7 {want} "
          f"({c['layers']} a step) and K6 {k6_runs(cfg)} × that")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"train: loss {losses} or grad norm {gnorms} not finite")
    check(losses[-1] < losses[0], f"train: the loss did not fall {losses}")
    peak = torch.cuda.max_memory_allocated()
    with card_trace() as prof:
        t1 = time.perf_counter()
        for i in range(c["steps"], c["steps"] + c["traced"]):
            params, state, m = step_fn(params, state, batches[i])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3 / c["traced"]
    dev_ms = {k: v / c["traced"] for k, v in train_device_ms(prof).items()}
    check(dev_ms["k6"] > 0 and dev_ms["k7"] > 0,
          f"train: the trace holds no K6 or K7 time {dev_ms}")
    # the step's two halves apart (after the checks; the updates below
    # move the parameters further): gradients, then AdamW on them
    _, grads = compute_grads(params, cfg, batches[-1])
    grads_ms = cuda_time_ms(lambda: compute_grads(params, cfg, batches[-1]),
                            1)
    update_ms = cuda_time_ms(
        lambda: apply_updates(params, grads, state, opt_cfg), 2)
    del grads
    ms = sorted(wall[1:])[len(wall[1:]) // 2]        # median after the first
    tokens = c["batch"] * c["seq"]
    row = dict(
        arch=c["arch"], batch=c["batch"], seq=c["seq"], remat=cfg.remat,
        params=numel,
        steps=c["steps"], losses=losses, grad_norms=gnorms,
        step_ms=wall, ms_per_step=ms, first_step_ms=wall[0],
        tokens_per_s=tokens / (ms / 1e3),
        mfu=6 * n_mfu * tokens / (ms / 1e3) / BF16_FLOP_PER_S,
        mfu_params=n_mfu,
        traced_ms_per_step=traced_ms,
        **{f"{k}_device_ms_per_step": v for k, v in dev_ms.items()},
        idle_share_est=max(0.0, 1.0 - dev_ms["busy"] / ms),
        grads_ms=grads_ms, update_ms=update_ms,
        peak_memory_gb=peak / 1e9, init_s=init_s,
        launches=launches)
    log("[train] " + json.dumps(on_card(row)))
    del params, state, batches, m
    torch.cuda.empty_cache()
    return row, launches


def train_card_vs_cpu(dev, arch, seed=0, **opt):
    """One train step of ``arch``'s reduced config in f32 on the card and
    on the CPU from the same parameters (drawn on the CPU, seed ``seed``,
    stacked) and the same batch (B=2, S=64: two mLSTM chunks; the vlm
    backbone with stub ``embeddings``): loss and grad norm within
    TRAIN_REL (relative), the first moment (the clipped gradients) within
    TRAIN_MU_REL of each leaf's max (two bf16 roundings, 2⁻⁷, with bf16
    gradients), the updated parameters within TRAIN_STEP_FRACTION of lr
    (2·lr with bf16 gradients), K6 = K7 = the attention layers' calls on
    the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synth import DataConfig, synth_batch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.launch.shapes import init_fn_for
    from repro_torch.models import lm
    from repro_torch.train.optim import init_opt_state, tree_leaves, tree_map
    from repro_torch.train.step import train_step
    cfg = get_config(arch).reduced().replace(dtype="float32")
    cpu = init_fn_for(cfg)(cfg, torch.Generator().manual_seed(seed),
                           stacked=True)
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    nb = synth_batch(cfg, DataConfig(global_batch=2, seq_len=64, seed=1), 0)
    if cfg.family == "vlm":
        nb["embeddings"] = (np.random.default_rng(2).standard_normal(
            (2, 64, cfg.d_model)) * 0.02).astype(np.float32)
    grad_accum = opt.pop("grad_accum", 1)
    opt_cfg = train_opt(**opt)
    out = {}
    for name, p, d in (("cpu", cpu, "cpu"), ("cuda", card, dev)):
        st = init_opt_state(p, opt_cfg)
        batch = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
        FK.reset_launch_counts()
        p, st, m = train_step(p, st, batch, cfg=cfg, opt_cfg=opt_cfg,
                              grad_accum=grad_accum)
        out[name] = (p, st, float(m["loss"]), float(m["grad_norm"]),
                     FK.launch_counts())
    (pc, sc, lc, gc, _), (pd, sd, ld, gd, launched) = out["cpu"], out["cuda"]
    # whisper: each encoder layer once, each decoder layer twice (self
    # and cross); K6 runs again in the backward under the default remat
    calls = grad_accum * (cfg.n_enc_layers + 2 * cfg.n_dec_layers
                          if cfg.family == "encdec"
                          else lm.attention_layers(cfg))
    check(launched == {"flash_attention_fwd": k6_runs(cfg) * calls,
                       "flash_attention_bwd": calls},
          f"train card vs CPU {arch}: launches {launched}, want K7 {calls} "
          f"and K6 {k6_runs(cfg)} × that (remat {cfg.remat})")
    rel_l, rel_g = abs(ld - lc) / abs(lc), abs(gd - gc) / abs(gc)
    check(rel_l <= TRAIN_REL and rel_g <= TRAIN_REL,
          f"train card vs CPU {arch}: loss rel {rel_l}, grad norm rel "
          f"{rel_g} > {TRAIN_REL}")
    dp = max(float((a.detach().cpu() - b.detach()).abs().max())
             for a, b in zip(tree_leaves(pd), tree_leaves(pc)))
    # the first moment is (1 − b1)·clip·g: the gradients, norm-wise per
    # leaf (an entry sums many terms in another order on each device);
    # bf16 gradients round each entry to 2⁻⁸ of itself, and entries that
    # differ in their last float32 bits may round to neighbours
    bf16 = opt_cfg.grad_compression == "bf16"
    mu_lim = 2 * 2.0 ** -8 if bf16 else TRAIN_MU_REL
    dm = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(tree_leaves(sd.mu), tree_leaves(sc.mu)))
    check(dm <= mu_lim, f"train card vs CPU {arch}: first moment "
          f"|Δ| / max|·| {dm} > {mu_lim}")
    # at step 1 an entry moves by lr·(g/(|g| + eps) + wd·p): where |g| is
    # near eps = 1e-8 a rounding of g moves it by up to lr·|Δg|/eps, so
    # the parameters are held to a fraction of one step's move (to two
    # moves with bf16 gradients: an entry rounded to 0 on one side moves
    # one step less)
    lim = (2.0 if bf16 else TRAIN_STEP_FRACTION) * opt_cfg.lr
    check(dp <= lim, f"train card vs CPU {arch}: parameters |Δ| {dp} > "
          f"{lim}")
    tag = ", ".join([f"{k}={v}" for k, v in opt.items()] +
                    ([f"grad_accum={grad_accum}"] if grad_accum > 1 else []))
    log(f"[train] card vs CPU, reduced {arch} f32"
        f"{' (' + tag + ')' if tag else ''}: loss {ld:.6f} rel {rel_l:.3e}, "
        f"grad norm rel {rel_g:.3e} (≤ {TRAIN_REL:g}), first moment "
        f"|Δ|/max {dm:.3e} (≤ {mu_lim:g}), parameters |Δ| {dp:.3e} = "
        f"{dp / opt_cfg.lr:.3e}·lr (≤ {lim / opt_cfg.lr:g}·lr); K7 = "
        f"{calls}, K6 = {k6_runs(cfg) * calls} (remat {cfg.remat})")
    return dict(arch=arch, loss_rel=rel_l, grad_norm_rel=rel_g,
                param_abs=dp, mu_rel=dm, **opt)


def train_resume(dev):
    """The reduced llama (bf16) through ``launch/train.main`` on the card:
    6 steps with checkpoints every 3 (the step-3 one written in the
    background while training goes on), then a fresh run on a directory
    holding only that step-3 checkpoint, resumed to 6: the final
    parameters bitwise equal."""
    import shutil
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.launch import train as T
    from repro_torch.train.optim import tree_leaves
    root = os.path.join(ROOT, "build", "train_resume")
    shutil.rmtree(root, ignore_errors=True)
    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    common = ["--arch", "llama3.2-3b", "--reduced", "--batch", "4", "--seq",
              "64", "--steps", "6", "--ckpt-every", "3", "--log-every", "3"]
    FK.reset_launch_counts()
    a = T.main(common + ["--ckpt-dir", a_dir])
    # 4 layers × 6 steps; K6 twice a layer under the default full remat
    check(FK.launch_counts() == {"flash_attention_fwd": 48,
                                 "flash_attention_bwd": 24},
          f"train resume: launches {FK.launch_counts()}, want K6 48 and "
          f"K7 24")
    os.makedirs(b_dir)
    shutil.copy(os.path.join(a_dir, "ckpt_0000000003.npz"), b_dir)
    b = T.main(common + ["--ckpt-dir", b_dir])
    same = all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    check(same, "train resume: the resumed run's parameters differ from "
          "the straight run's")
    shutil.rmtree(root, ignore_errors=True)
    log("[train] resume: reduced llama3.2-3b bf16 on the card, 6 steps "
        "straight = 3, checkpoint, resume to 6: parameters bitwise equal")


def train_twin(dev, trials=7, steps=5):
    """``examples/hpo_train_torch.py`` on the card: a GPSampler (D-BE)
    tunes lr and weight decay of a reduced f32 LM (2 layers), ``trials``
    trials of ``steps`` steps: K1–K4 in the sampler, K7 = 2 layers ×
    steps × trials in the objective and K6 twice that (the default full
    remat), counted alone."""
    import torch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.matern import kernel as MK
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import hpo_train_torch
    FK.reset_launch_counts()
    MK.reset_launch_counts()
    t0 = time.perf_counter()
    s = hpo_train_torch.main(["--trials", str(trials), "--steps",
                              str(steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fl, ml = FK.launch_counts(), MK.launch_counts()
    want = 2 * steps * trials
    check(fl == {"flash_attention_fwd": 2 * want,
                 "flash_attention_bwd": want},
          f"hpo_train twin: K6/K7 launches {fl}, want {2 * want}/{want}")
    check(all(v > 0 for v in ml.values()), f"hpo_train twin: K1–K4 "
          f"launches {ml}")
    best = s.best()
    check(math.isfinite(best.y), f"hpo_train twin: best {best.y}")
    log(f"[train] hpo_train twin: {trials} trials × {steps} steps in "
        f"{wall:.1f} s, best loss {best.y:.4f}; K7 = {want}, K6 = "
        f"{2 * want}, K1–K4 {json.dumps(ml)}")
    return dict(wall_s=wall, best=best.y, flash=fl, matern=ml)


def phase_train(dev):
    """Slice 9: the full-width train steps, the six families' reduced
    configs card against CPU (and grad_accum 2, bf16 gradients on the
    dense one), the bitwise resume, the hpo_train twin."""
    t0 = time.perf_counter()
    row, launches = train_full_width(dev)
    rows = [train_card_vs_cpu(dev, a) for a in TRAIN_FAMILIES]
    rows.append(train_card_vs_cpu(dev, "llama3.2-3b", grad_accum=2))
    rows.append(train_card_vs_cpu(dev, "llama3.2-3b",
                                  grad_compression="bf16"))
    train_resume(dev)
    twin = train_twin(dev)
    log(f"[time] train: {time.perf_counter() - t0:.1f} s")
    return dict(full=row, card_vs_cpu=rows, twin=twin), launches


# slice 11: llama3.2-3b at full width and depth, bf16, B=8 (the batch PR
# 25 cut to 4 for memory), one compute_grads a remat mode on one set of
# parameters and one batch, then train steps under full remat
TRAIN_REMAT = dict(TRAIN, batch=8, remat="full")
REMAT_MODES = ("none", "full", "dots")


def remat_grads(dev, c=TRAIN_REMAT):
    """One ``compute_grads`` under each remat mode on the same parameters
    (seed 0, stacked) and batch (DataConfig(B, S, seed 0)): a warm call,
    then one timed with CUDA events after reset_peak_memory_stats (its
    peak: parameters, batch, activations or what remat keeps, and the
    gradients).  "none"'s loss and gradients go to the host; the other
    modes must equal them bitwise (the same shapes give cuBLAS the same
    algorithms; K6 sums in a fixed order, so its recompute and its lse
    are the same bits): if not, the largest |Δ| of each leaf that
    differs is logged and the phase fails.  Everything is freed between
    modes.  → {mode: row}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synth import DataConfig, synth_batch
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.launch.shapes import init_fn_for
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import compute_grads
    cfg0 = get_config(c["arch"])
    params = init_fn_for(cfg0)(
        cfg0, torch.Generator(device=dev).manual_seed(0), stacked=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        cfg0, DataConfig(global_batch=c["batch"], seq_len=c["seq"], seed=0),
        0).items()}
    rows, ref = {}, None
    for mode in REMAT_MODES:
        cfg = cfg0.replace(remat=mode)
        compute_grads(params, cfg, batch)                    # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        FK.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, grads = compute_grads(params, cfg, batch)
        end.record()
        torch.cuda.synchronize()
        row = dict(remat=mode, grads_ms=start.elapsed_time(end),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   held_before_gb=held / 1e9, loss=float(loss),
                   launches=FK.launch_counts())
        want = c["layers"]
        check(row["launches"] == {
            "flash_attention_fwd": (1 if mode == "none" else 2) * want,
            "flash_attention_bwd": want},
            f"remat {mode}: launches {row['launches']}, want K7 {want}")
        leaves = tree_leaves(grads)
        if ref is None:
            ref = (loss.cpu(), [g.cpu() for g in leaves])
        else:
            diffs = {}
            for i, (g, r) in enumerate(zip(leaves, ref[1])):
                r = r.to(dev)
                if not torch.equal(g, r):
                    diffs[i] = float((g.float() - r.float()).abs().max())
                del r
            row["loss_bitwise"] = bool(torch.equal(loss.cpu(), ref[0]))
            row["grads_bitwise"] = not diffs
            if diffs or not row["loss_bitwise"]:
                log(f"[remat] {mode} against none: loss {float(loss)!r} vs "
                    f"{float(ref[0])!r}; largest |Δ| per leaf that differs "
                    f"{json.dumps(diffs)}")
            check(row["loss_bitwise"], f"remat {mode}: the loss differs "
                  f"from remat none's")
            check(not diffs, f"remat {mode}: {len(diffs)} gradient leaves "
                  f"differ from remat none's")
        del loss, grads, leaves
        torch.cuda.empty_cache()
        rows[mode] = row
        log("[remat] " + json.dumps(on_card(row)))
    del params, batch, ref
    torch.cuda.empty_cache()
    check(rows["full"]["peak_gb"] < rows["none"]["peak_gb"],
          f"remat: the gradient half's peak under full "
          f"({rows['full']['peak_gb']:.2f} GB) is not below none's "
          f"({rows['none']['peak_gb']:.2f} GB)")
    return rows


def dryrun_live_gb(c):
    """The dry run's bytes held (``launch/dryrun.py``'s
    live_bytes_per_device, counted on meta) for a train step of ``c``'s
    arch, batch, sequence and remat, one microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.shapes import ShapeCell
    cfg = get_config(c["arch"]).replace(remat=c["remat"])
    rec = cell_record(cfg, ShapeCell(f"train_b{c['batch']}", "train",
                                     c["seq"], c["batch"]), grad_accum=1)
    return rec["live_bytes_per_device"] / 1e9, rec["memory"]


def phase_train_remat(dev):
    """Slice 11: remat at full width (llama3.2-3b, bf16, B=8, S=512):
    remat_grads' three modes, bitwise; then train_full_width under full
    remat (8 steps, 3 traced: K6 = 56 and K7 = 28 a step); the dry run's
    bytes held for this cell and for TRAIN's (B=4, remat none) beside
    the measured peaks (logged, not gated).  → (row, the train launches
    under full remat)."""
    t0 = time.perf_counter()
    grads = remat_grads(dev)
    full, launches = train_full_width(dev, TRAIN_REMAT)
    row = dict(grads=grads, full=full)
    for tag, c in (("b8_full", TRAIN_REMAT), ("b4_none", TRAIN)):
        row[f"dryrun_{tag}_live_gb"], row[f"dryrun_{tag}_memory"] = \
            dryrun_live_gb(c)
    row["measured_b8_full_step_peak_gb"] = full["peak_memory_gb"]
    row["measured_b8_full_grads_peak_gb"] = grads["full"]["peak_gb"]
    row["gap_b8_full_gb"] = (full["peak_memory_gb"]
                             - row["dryrun_b8_full_live_gb"])
    row["phase_s"] = time.perf_counter() - t0
    log("[remat] " + json.dumps(on_card(row)))
    log(f"[time] train remat: {row['phase_s']:.1f} s")
    return row, launches


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
    phase_flash_kernels(dev, err)
    phase_kvp_kernels(dev, err)
    sampler, obj, launches1, per_ask, c3, state = phase_main(dev)
    from repro_torch.engine.plan import EvalPlan
    plan = EvalPlan.for_batch(sampler.B, sampler.space.dim,
                              bucketed=sampler.mso_options.bucketed)
    phase_main_shapes(state, plan.buckets, err)
    asker, obj2, launches, ask_rows, _ = phase_ask(dev)
    phase_ask_shapes(asker, err)
    launches["kvp_fwd"] = phase_kvp_path(asker, err)
    phase_fit_census(dev)
    phase_breakdown(sampler, obj)
    phase_ask_breakdown(asker, obj2, ask_rows)
    timing = phase_timing(dev, state)
    gram_timing = phase_gram_timing(dev)
    log(f"[time] slices 1-2 and the BO timing: "
        f"{time.perf_counter() - t_start:.1f} s")
    serve_row, launches["flash_attention_fwd"] = phase_serve(dev)
    log(f"[time] serve: {time.perf_counter() - t_start:.1f} s")
    _, families_launches = phase_serve_families(dev)
    log(f"[time] families: {time.perf_counter() - t_start:.1f} s")
    _, whisper_launches = phase_whisper(dev)
    whisper_t = phase_whisper_kernels(dev, err)
    log(f"[time] whisper: {time.perf_counter() - t_start:.1f} s")
    timing3 = phase_slice3_timing(dev)
    families_t = phase_families_timing(dev)
    paper = phase_paper(dev, state, sampler)
    log(f"[time] slice 3 and 7 timing, paper: "
        f"{time.perf_counter() - t_start:.1f} s")
    phase_fleet_kernels(dev, err)
    fleet = phase_fleet(dev)
    fleet_t = fleet_timing(dev)
    log(f"[time] fleet: {time.perf_counter() - t_start:.1f} s")
    service = phase_service(dev)
    log(f"[time] service: {time.perf_counter() - t_start:.1f} s")
    train_k = phase_train_kernels(dev, err)
    train, train_launches = phase_train(dev)
    log(f"[time] train: {time.perf_counter() - t_start:.1f} s")
    remat, remat_launches = phase_train_remat(dev)
    log(f"[time] train remat: {time.perf_counter() - t_start:.1f} s")

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
            "bound_by": row[f"{key}_bound_by"], "library_ms": None,
            "ms_from": row[f"{key}_ms_from"],
            # the fleet path (slice 4): its launches, and the call at its
            # shape, S = 8 studies in one launch
            "fleet_launches": fleet["launches"][name],
            # the BO service's GP rounds (slice 6), counted alone
            "service_launches": service["launches"][name],
            # the quickstart twin's path (slice 5), counted alone
            "quickstart_launches": paper["launches"]["quickstart"][name],
            **fleet_t[key]})
    # the serving path's shape: a decode step, 8 slots at positions
    # 64–104 of a 512-slot bf16 cache; the kvp path's: q = B = 10 at
    # n = 544, D = 20
    for name, key, row, src, replaces, lib in (
            ("kvp_fwd", "kvp", timing3[4],
             "src/repro_torch/kernels/kvp/csrc/kvp.cu",
             "src/repro/kernels/kvp/kernel.py:47", None),
            ("flash_attention_fwd", "flash", timing3[2],
             "src/repro_torch/kernels/flash/csrc/flash.cu",
             "src/repro/kernels/flash/kernel.py:82", "flash_sdpa")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[key], "ms": row[f"{key}_ms"],
            "plain_ms": row[f"{key}_plain_ms"],
            "bound_ms": row[f"{key}_bound_ms"],
            "bound_by": row[f"{key}_bound_by"],
            "library_ms": row[f"{lib}_ms"] if lib else None,
            # "events" where the trace held no device time: back-to-back
            # calls, launch gaps included
            "ms_from": row[f"{key}_ms_from"],
            "library_ms_from": row[f"{lib}_ms_from"] if lib else None,
            # the serve twin's path (slice 5), counted alone; the moe,
            # vlm, hybrid (slice 7) and ssm (slice 8: none) serving paths,
            # each counted alone, and K6 at the qwen3 and recurrentgemma
            # serving steps; whisper's encode and decode steps (slice 8)
            # and K6 at its four calls
            **({"serve_twin_launches": paper["launches"]["serve"],
                "families_launches": families_launches,
                "whisper_launches": whisper_launches,
                # slice 9: the full-width train steps (28 a step), and
                # K6 with its log-sum-exp at their shape
                "train_launches": train_launches["flash_attention_fwd"],
                # slice 11: the B=8 train steps under full remat (56 a
                # step: each layer's forward again in the backward)
                "train_remat_launches":
                    remat_launches["flash_attention_fwd"],
                "train_timing": {
                    key: train_k[key] for key in (
                        "shape", "flash_ms", "flash_ms_from", "flash_lse_ms",
                        "flash_lse_ms_from", "flash_lse_call_ms",
                        "flash_lse_plain_ms", "flash_lse_bound_ms",
                        "flash_lse_bound_by", "sdpa_fwd_ms")},
                **{f"{path}_timing": {
                    a: {key: r[key] for key in (
                        "flash_ms", "flash_ms_from", "flash_plain_ms",
                        "flash_bound_ms", "flash_bound_by", "flash_sdpa_ms",
                        "max_abs_err")}
                    for a, r in rows.items()}
                   for path, rows in (("families", families_t),
                                      ("whisper", whisper_t))}}
               if name == "flash_attention_fwd" else {})})
    # K7 replaces no TPU kernel: the reference differentiates
    # attention_xla through XLA; at the full-width train step's shape
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash/csrc/flash_bwd.cu",
        "replaces": "src/repro/models/layers.py:147",
        "replaces_note": "no TPU kernel: XLA autodiff of attention_xla",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": err["flash_bwd"], "ms": train_k["flash_bwd_ms"],
        "plain_ms": train_k["flash_bwd_plain_ms"],
        "bound_ms": train_k["flash_bwd_bound_ms"],
        "bound_by": train_k["flash_bwd_bound_by"],
        "library_ms": train_k["sdpa_bwd_ms"],
        "ms_from": train_k["flash_bwd_ms_from"],
        "library_ms_from": train_k["sdpa_bwd_ms_from"],
        "call_ms": train_k["flash_bwd_call_ms"],
        "kernels_us": train_k["flash_bwd_kernels"],
        # slice 10: bwd_plan's path at this shape, and K7 at whisper's
        # encoder shape (hd 64, not causal) beside SDPA's backward
        "plan": train_k["flash_bwd_plan"],
        "whisper_timing": train_k["whisper_bwd"],
        "train": {k: train["full"][k] for k in (
            "ms_per_step", "tokens_per_s", "mfu", "k7_device_ms_per_step",
            "busy_device_ms_per_step", "peak_memory_gb")},
        # slice 11: the B=8 train steps under full remat (28 a step)
        "train_remat_launches": remat_launches["flash_attention_bwd"],
        "train_remat": {k: remat["full"][k] for k in (
            "ms_per_step", "tokens_per_s", "mfu", "k6_device_ms_per_step",
            "k7_device_ms_per_step", "busy_device_ms_per_step",
            "peak_memory_gb")}})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
