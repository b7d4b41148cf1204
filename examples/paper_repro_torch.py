"""Reproduce the paper's core phenomena in one run, on the PyTorch port:

1. C3: D-BE per-restart trajectories are IDENTICAL to SEQ. OPT.
2. C2: C-BE's off-diagonal artifacts inflate L-BFGS-B iterations.
3. wall-clock: the evaluation rounds and wall time of SEQ, D-BE, C-BE and
   the vectorized D-BE (dbe_vec) on a batched-evaluation objective.

    PYTHONPATH=src python examples/paper_repro_torch.py [--device cpu]

Batched Rosenbrock, B = 10 restarts in D = 5 on [0, 3].  Every strategy
runs through ``maximize_acqf(..., acq_state=None)`` and the process-wide
engine of the objective (``engine.default_engine``) on ``--device``,
the card by default.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core.mso import MsoOptions, maximize_acqf
from repro_torch.engine.engine import default_engine

STRATEGIES = ("seq", "dbe", "cbe", "dbe_vec")


def neg_rosen(state, X):
    """Negated Rosenbrock over the rows of X (k, D): every row's value in
    one batched call (the rows are independent)."""
    del state
    return -(100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2
             + (1.0 - X[:, :-1]) ** 2).sum(-1)


def run(device=None, B=10, D=5, verbose=True) -> dict:
    """All four strategies from the same restarts; returns each one's
    MsoResult and the paper's two claims."""
    x0 = np.random.default_rng(0).uniform(0, 3, (B, D))
    opts = MsoOptions(m=10, maxiter=200, pgtol=1e-8)
    # None: maximize_acqf itself takes the default engine, on the card
    engine = None if device is None else default_engine(neg_rosen, device)
    results = {}
    for s in STRATEGIES:
        r = maximize_acqf(neg_rosen, x0, 0.0, 3.0, acq_state=None,
                          strategy=s, options=opts, engine=engine)
        results[s] = r
        if verbose:
            print(f"{s:8s} best={r.best_acq:+.3e} "
                  f"iters(med)={np.median(r.n_iters):6.1f} "
                  f"eval_rounds={r.n_rounds:4d} "
                  f"wall={1e3 * r.wall_time:.1f}ms")
    seq, dbe, cbe = results["seq"], results["dbe"], results["cbe"]
    c3 = bool(np.array_equal(seq.x, dbe.x)
              and np.array_equal(seq.n_iters, dbe.n_iters)
              and np.array_equal(seq.n_evals, dbe.n_evals))
    inflation = float(np.median(cbe.n_iters) / np.median(dbe.n_iters))
    if verbose:
        print(f"\nC3  D-BE trajectories identical to SEQ. OPT.: {c3}")
        print(f"C2  C-BE iteration inflation vs D-BE: {inflation:.1f}x")
        print(f"    D-BE eval rounds vs SEQ: {seq.n_rounds} -> "
              f"{dbe.n_rounds} ({seq.n_rounds / dbe.n_rounds:.1f}x fewer)")
    return dict(results=results, c3=c3, c2_inflation=inflation)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    out = main()
    sys.exit(0 if out["c3"] else 1)
