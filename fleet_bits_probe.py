"""Where a fleet study's bits leave its solo sampler's: op by op.

    python3 fleet_bits_probe.py [--device cpu] [--studies S] [--dim D]
                                [--n N] [--pad P] [--restarts B]

Builds one fleet block of S Rastrigin studies (default chip_smoke.py's
FLEET: S = 8, D = 20, n = 536 live rows in the 544 bucket, B = 10
restarts, R = 2 MAP restarts, the fused posterior backend on the card,
"cholesky" on the CPU) and runs each block program of
``engine/fleet.py`` once on the whole block: the full refit, the MSO from
its state, a rank-one update after one more observation a study, its
MSO, and the fallback (a full refit warm-started from the fitted θ).
For each study it then runs the solo programs of ``engine/ask.py`` on
the same inputs and compares the bits, in the order the pipeline runs:

  raw ops   the torch ops the fit is built from, issued once on the
            stacked (S, ...) tensors and once on a study's slice: the
            Matérn gram, ``torch.linalg.cholesky``, ``cholesky_solve``,
            ``solve_triangular``, a matrix-vector product, a row sum over
            the bucket, the lockstep solver's ``_dot`` over S·R and S·B
            rows, and the backward of cholesky + cholesky_solve (these
            say which ops the card rounds otherwise in a batch; the
            library must not issue the ones that do on a stack);
  library   standardize_masked, the MAP objective and its θ-gradient at
            the fit's inits, the full refit's θ / chol / α / K⁻¹, the
            MSO's suggestion, the rank-one update's chol / α / K⁻¹ / ok,
            its MSO's suggestion, the fallback's θ / chol / α / K⁻¹.

Prints one line per check (max |Δ| over the studies, "bitwise" or not),
then the first library step whose bits differ, and one JSON line.  Exits
1 if any library step differs, 0 if every study is bitwise its solo
programs.  Without ``--device`` it needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def block_data(S, D, n, b, seed=0):
    """S studies' padded buffers: n uniform unit-cube rows, each scored by
    the port's Rastrigin (BBOB f15) on [-5, 5]^D, and one more row each
    for the rank-one update, _FAR rows after them; (x (S, b, D), y (S, b))
    as float64 numpy."""
    import numpy as np
    from repro_torch.bo.objectives import make_objective
    from repro_torch.gp.fit import _FAR
    obj = make_objective("rastrigin", D)
    rng = np.random.default_rng(seed)
    x = np.full((S, b, D), _FAR) + np.arange(b)[None, :, None]
    y = np.zeros((S, b))
    u = rng.uniform(0, 1, (S, n + 1, D))
    x[:, :n + 1] = u
    y[:, :n + 1] = [[obj(-5.0 + 10.0 * r) for r in rows] for rows in u]
    return x, y


class Report:
    def __init__(self):
        self.rows = []

    def add(self, part, name, a, b):
        """a: the stacked result (leading S); b: the S solo results."""
        import torch
        diffs = []
        for s, bs in enumerate(b):
            x, y = a[s], bs
            if x.dtype == torch.bool:
                x, y = x.to(torch.int64), y.to(torch.int64)
            same = torch.equal(x, y)
            diffs.append(0.0 if same else float((x - y).abs().max()))
        row = dict(part=part, name=name, max_abs=max(diffs),
                   bitwise=all(d == 0.0 for d in diffs),
                   studies_off=sum(d != 0.0 for d in diffs))
        self.rows.append(row)
        print(f"[probe] {part:7s} {name:42s} "
              f"{'bitwise' if row['bitwise'] else 'DIFFERS'}"
              f"  max|Δ| {row['max_abs']:.3e} ({row['studies_off']} of "
              f"{len(diffs)} studies)", flush=True)


def raw_ops(rep, dev, x, ys, valid, thetas, D, B):
    """The building blocks, stacked against one slice, without the
    library's per-study routing."""
    import torch
    from repro_torch.core.lbfgsb import _dot
    from repro_torch.gp.fit import unpack_theta
    from repro_torch.gp.kernels import KERNELS
    S = x.shape[0]
    p = unpack_theta(thetas, D)
    k = KERNELS["matern52"](x, x, p)                          # (S, R, b, b)
    k1 = [KERNELS["matern52"](x[s], x[s], unpack_theta(thetas[s], D))
          for s in range(S)]
    rep.add("raw", "Matérn gram (K3 on the card)", k, k1)
    v = valid.to(x.dtype)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=dev)
    K = (k + (p.noise + 1e-8)[..., None, None] * eye) * \
        (v[:, None, :, None] * v[:, None, None, :]) + \
        torch.diag_embed(1.0 - v)[:, None]
    L = torch.linalg.cholesky(K)
    rep.add("raw", "torch.linalg.cholesky (S,R,b,b)", L,
            [torch.linalg.cholesky(K[s]) for s in range(S)])
    yv = (ys * v)[:, None, :, None].expand(K.shape[:-1] + (1,))
    a = torch.cholesky_solve(yv, L)
    rep.add("raw", "torch.cholesky_solve (S,R,b,1)", a,
            [torch.cholesky_solve(yv[s], L[s]) for s in range(S)])
    rs = (yv[..., 0] * a[..., 0]).sum(-1)
    rep.add("raw", "row sum over b (S,R,b)", rs,
            [(yv[s, ..., 0] * a[s, ..., 0]).sum(-1) for s in range(S)])
    col = k[:, 0, :, :1]                                       # (S, b, 1)
    z = torch.linalg.solve_triangular(L[:, 0], col, upper=False)
    rep.add("raw", "torch.linalg.solve_triangular (S,b,1)", z,
            [torch.linalg.solve_triangular(L[s, 0], col[s], upper=False)
             for s in range(S)])
    w = L[:, 0] @ col
    rep.add("raw", "matrix-vector product (S,b,b)@(S,b,1)", w,
            [L[s, 0] @ col[s] for s in range(S)])
    g = torch.Generator(device="cpu").manual_seed(1)
    for rows, width, tag in ((thetas.shape[1], thetas.shape[2], "S·R"),
                             (B, D, "S·B")):
        u1 = torch.randn((S * rows, width), generator=g,
                         dtype=torch.float64).to(dev)
        u2 = torch.randn((S * rows, width), generator=g,
                         dtype=torch.float64).to(dev)
        rep.add("raw", f"lbfgsb _dot over {tag} rows, width {width}",
                _dot(u1, u2).reshape(S, rows),
                [_dot(u1[s * rows:(s + 1) * rows],
                      u2[s * rows:(s + 1) * rows]) for s in range(S)])

    def chol_solve_grad(Km, yvm):
        Km = Km.detach().requires_grad_(True)
        with torch.enable_grad():
            Lm = torch.linalg.cholesky(Km)
            am = torch.cholesky_solve(yvm, Lm)
            (gk,) = torch.autograd.grad((am * yvm).sum()
                                        + Lm.diagonal(dim1=-2,
                                                      dim2=-1).log().sum(),
                                        Km)
        return gk
    rep.add("raw", "backward of cholesky + cholesky_solve",
            chol_solve_grad(K, yv),
            [chol_solve_grad(K[s], yv[s]) for s in range(S)])


def library(rep, dev, x, y, n, thetas, D, B, backend):
    """The block programs against the solo programs, in pipeline order."""
    import torch
    from repro_torch.core.lbfgsb import LbfgsbOptions
    from repro_torch.engine.ask import (AskConfig, AskEngine, incr_core,
                                        refit_core)
    from repro_torch.engine.engine import EvalEngine
    from repro_torch.engine.fleet import (FleetConfig, FleetEngine,
                                          default_draws)
    from repro_torch.engine.posterior import fused_logei_acq
    from repro_torch.gp.fit import (FIT_OPTS, _neg_map_objective,
                                    standardize_masked, theta_bounds,
                                    theta_init_grid, unpack_theta)
    S, b = x.shape[0], x.shape[1]
    R = thetas.shape[1]
    mso = LbfgsbOptions(m=10, maxiter=200, pgtol=1e-2, ftol=0.0, maxls=25)
    eng = EvalEngine(fused_logei_acq(backend), dev)
    fleet = FleetEngine(eng, FleetConfig(dim=D, n_restarts=B, slots=S,
                                         backend=backend, pad_bucket=b,
                                         mso=mso))
    ask = AskEngine(eng, AskConfig(dim=D, n_restarts=B, backend=backend,
                                   pad_bucket=b, mso=mso))
    tlo, tup = theta_bounds(D, torch.float64, dev)
    lo, hi = tlo.expand(thetas.shape), tup.expand(thetas.shape)
    nv = torch.full((S,), n, dtype=torch.int64, device=dev)
    valid = torch.arange(b, device=dev) < nv[:, None]
    ys = standardize_masked(-y, valid)[0]
    rep.add("library", "standardize_masked", ys,
            [standardize_masked(-y[s], valid[s])[0] for s in range(S)])

    def objective(th, *args):
        th = th.detach().requires_grad_(True)
        with torch.enable_grad():
            f = _neg_map_objective(th, *args, D, "matern52")
            (g,) = torch.autograd.grad(f.sum(), th)
        return f.detach(), g
    f_all, g_all = objective(thetas, x, ys, valid)
    solo = [objective(thetas[s], x[s], ys[s], valid[s]) for s in range(S)]
    rep.add("library", "MAP objective at the inits", f_all,
            [o[0] for o in solo])
    rep.add("library", "MAP θ-gradient at the inits", g_all,
            [o[1] for o in solo])

    def refit(tag, n_now, th):
        nvv = torch.full((S,), n_now, dtype=torch.int64, device=dev)
        lo_, hi_ = tlo.expand(th.shape), tup.expand(th.shape)
        keep = torch.zeros_like(th[:, 0])
        out = fleet._full_impl(x, y, nvv, th, lo_, hi_,
                               torch.ones((S,), dtype=torch.bool,
                                          device=dev),
                               keep, torch.zeros((S, b, b), device=dev,
                                                 dtype=x.dtype),
                               torch.zeros((S, b), device=dev,
                                           dtype=x.dtype),
                               None if backend == "cholesky" else
                               torch.zeros((S, b, b), device=dev,
                                           dtype=x.dtype))
        one = [refit_core(x[s], y[s], n_now, th[s], lo_[s], hi_[s], dim=D,
                          kernel="matern52", backend=backend,
                          fit_opts=FIT_OPTS) for s in range(S)]
        for j, key in ((2, "θ"), (3, "chol"), (4, "α"), (5, "K⁻¹")):
            if one[0][j] is not None:
                rep.add("library", f"{tag}: {key}", out[j - 2],
                        [o[j] for o in one])
        return out[:4], [o[2:6] for o in one]

    def mso(tag, step, n_now, state, solo_states):
        draws = torch.stack([default_draws(s, step, B - 1, D)
                             for s in range(S)]).to(dev)
        nvv = torch.full((S,), n_now, dtype=torch.int64, device=dev)
        bx, _ = fleet._mso_impl(draws, x, y, nvv, *state)
        one = []
        for s in range(S):
            vs = torch.arange(b, device=dev) < n_now
            ys1 = standardize_masked(-y[s], vs)[0]
            th, ch, al, ki = solo_states[s]
            one.append(ask._mso_tail(draws[s], x[s], ys1, vs,
                                     unpack_theta(th, D), ch, al, ki)[0])
        rep.add("library", f"{tag}: MSO suggestion", bx, one)

    state, solo_states = refit("full refit", n, thetas)
    mso("full refit", 0, n, state, solo_states)
    # one more observation a study, at fixed θ
    nv1 = torch.full((S,), n + 1, dtype=torch.int64, device=dev)
    _, _, _, chol1, alpha1, kinv1, ok1 = incr_core(
        x, y, nv1, state[0], state[1], state[3], dim=D, kernel="matern52")
    one = [incr_core(x[s], y[s], n + 1, solo_states[s][0],
                     solo_states[s][1], solo_states[s][3], dim=D,
                     kernel="matern52") for s in range(S)]
    rep.add("library", "rank-one: chol", chol1, [o[3] for o in one])
    rep.add("library", "rank-one: α", alpha1, [o[4] for o in one])
    if kinv1 is not None:
        rep.add("library", "rank-one: K⁻¹", kinv1, [o[5] for o in one])
    rep.add("library", "rank-one: ok", ok1, [o[6] for o in one])
    mso("rank-one", 1, n + 1, (state[0], chol1, alpha1, kinv1),
        [(solo_states[s][0], o[3], o[4], o[5]) for s, o in enumerate(one)])
    # the fallback: a full refit warm-started from the fitted θ
    warm = torch.stack([theta_init_grid(D, torch.float64, R, 100 + s,
                                        init=unpack_theta(state[0][s].cpu(),
                                                          D))
                        for s in range(S)]).to(dev)
    refit("fallback", n + 1, warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--studies", type=int, default=8)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--n", type=int, default=536)
    ap.add_argument("--pad", type=int, default=32)
    ap.add_argument("--restarts", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    from repro_torch import resolve_device
    from repro_torch.gp.fit import pad_bucket_for, theta_init_grid
    torch.set_num_threads(1)
    dev = resolve_device(args.device)
    S, D, n = args.studies, args.dim, args.n
    b = pad_bucket_for(n + 1, args.pad)
    backend = "fused" if dev.type == "cuda" else "cholesky"
    xn, yn = block_data(S, D, n, b)
    x, y = torch.as_tensor(xn).to(dev), torch.as_tensor(yn).to(dev)
    thetas = torch.stack([theta_init_grid(D, torch.float64, 2, s)
                          for s in range(S)]).to(dev)
    print(f"[probe] {S} studies, D={D}, n={n} in the {b} bucket, "
          f"B={args.restarts}, R=2, backend {backend}, device {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""), flush=True)
    rep = Report()
    from repro_torch.gp.fit import standardize_masked
    valid = torch.arange(b, device=dev) < n
    ys = standardize_masked(-y, valid.expand(S, b))[0]
    raw_ops(rep, dev, x, ys, valid.expand(S, b), thetas, D, args.restarts)
    library(rep, dev, x, y, n, thetas, D, args.restarts, backend)
    first = next((r for r in rep.rows
                  if r["part"] == "library" and not r["bitwise"]), None)
    print("[probe] first library step off its solo bits: "
          + (first["name"] if first else "none"), flush=True)
    print(json.dumps(dict(studies=S, dim=D, n=n, bucket=b, backend=backend,
                          first_off=first and first["name"],
                          rows=rep.rows)))
    return 1 if first else 0


if __name__ == "__main__":
    sys.exit(main())
