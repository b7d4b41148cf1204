"""Multi-start acquisition-function optimization: the paper's Algorithm 1/2.

Counterpart of ``repro/core/mso.py`` for the scipy-driven strategies:

* ``seq``  — SEQ. OPT.: B sequential scipy L-BFGS-B runs (Algorithm 2).
* ``cbe``  — C-BE: one scipy L-BFGS-B over the flattened (B·D,) summed
             objective (off-diagonal artifacts).
* ``dbe``  — D-BE (paper): coroutine-decoupled scipy workers + batched
             evaluation, shrinking active set.

All strategies *maximize* the acquisition (internally minimizing its
negation) and route every evaluation through one
:class:`~repro_torch.engine.engine.EvalEngine`; they differ only in who
drives the quasi-Newton updates.  The lockstep ``dbe_vec`` comes with a
later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import coroutine as co
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.plan import EvalPlan

STRATEGIES = ("seq", "cbe", "dbe")

# acq_fn(state, X:(k,D)|(k,q,D)) -> (k,) acquisition values (max scale)
AcqStateFn = Callable[[Any, torch.Tensor], torch.Tensor]


@dataclass
class MsoOptions:
    m: int = 10                  # L-BFGS-B memory
    maxiter: int = 200           # per-restart iteration cap (paper setting)
    pgtol: float = 1e-2          # paper: ||∇α||_inf ≤ 1e-2
    maxls: int = 25
    ftol: float = 0.0            # disabled by default, like the paper
    bucketed: bool = True        # geometric eval buckets (False: pad-to-B)


@dataclass
class MsoResult:
    x: np.ndarray                # (B, D) / (B, q, D) per-restart maximizers
    acq: np.ndarray              # (B,)  acquisition values (max scale)
    best_x: np.ndarray           # (D,) / (q, D)
    best_acq: float
    n_iters: np.ndarray          # (B,) QN iterations per restart
    n_evals: np.ndarray          # (B,) objective evals per restart
    n_rounds: int                # batched evaluation rounds (wall-clock proxy)
    wall_time: float
    strategy: str
    q: int = 1
    engine_stats: Optional[dict] = None   # EvalEngine.stats_snapshot()


def _state_device(state) -> Optional[torch.device]:
    """Device of the first tensor found in an acquisition state."""
    items = state if isinstance(state, (tuple, list)) else (state,)
    for item in items:
        if isinstance(item, torch.Tensor):
            return item.device
        x = getattr(item, "x_train", None)
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def maximize_acqf(
    acq_fn: AcqStateFn,
    x0: np.ndarray,
    lower,
    upper,
    *,
    acq_state: Any = None,
    strategy: str = "dbe",
    options: Optional[MsoOptions] = None,
    q: int = 1,
    engine: Optional[EvalEngine] = None,
) -> MsoResult:
    """Run MSO with the chosen strategy.

    ``x0``: (B, D) restart points, or (B, q, D) joint blocks when q > 1.
    ``engine``: reuse a long-lived :class:`EvalEngine` (a BO sampler keeps
    one per run); by default a fresh one on the device of ``acq_state``'s
    tensors.
    """
    if strategy == "dbe_vec":
        raise NotImplementedError(
            "strategy 'dbe_vec' (device lockstep solve) is not ported yet: "
            "ROADMAP queue A item 5")
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    options = options if options is not None else MsoOptions()

    x0 = np.asarray(x0, np.float64)
    if q > 1:
        if x0.ndim != 3 or x0.shape[1] != q:
            raise ValueError(f"q={q} needs x0 of shape (B, q, D); "
                             f"got {x0.shape}")
    elif x0.ndim != 2:
        raise ValueError(f"x0 must be (B, D); got {x0.shape}")
    B = x0.shape[0]
    D = x0.shape[-1]

    plan = EvalPlan.for_batch(B, D, q=q, bucketed=options.bucketed)
    if engine is None:
        dev = _state_device(acq_state)
        if dev is None:
            raise ValueError("no tensor in acq_state to take a device "
                             "from; pass engine=EvalEngine(acq_fn, device)")
        engine = EvalEngine(acq_fn, device=dev)

    # flat (B, q·D) view for the QN solvers; bounds tile across the q axis
    x0f = x0.reshape(B, plan.flat_dim)
    lower = np.broadcast_to(np.asarray(lower, np.float64), (D,))
    upper = np.broadcast_to(np.asarray(upper, np.float64), (D,))
    lowf = np.tile(lower, q)
    upf = np.tile(upper, q)

    batch_eval = engine.evaluator(acq_state, plan)
    kw = dict(m=options.m, maxiter=options.maxiter, pgtol=options.pgtol,
              maxls=options.maxls, factr=0.0)
    t0 = time.perf_counter()
    if strategy == "seq":
        out = co.run_seq_opt(batch_eval, x0f, lowf, upf, **kw)
    elif strategy == "cbe":
        out = co.run_cbe(batch_eval, x0f, lowf, upf, **kw)
    else:
        out = co.run_dbe_coroutine(batch_eval, x0f, lowf, upf, **kw)
    wall = time.perf_counter() - t0

    acq = -out.f
    best = int(np.argmax(acq))
    xs = out.x.reshape(x0.shape)
    return MsoResult(x=xs, acq=acq, best_x=xs[best],
                     best_acq=float(acq[best]), n_iters=out.n_iters,
                     n_evals=out.n_evals, n_rounds=out.n_rounds,
                     wall_time=wall, strategy=strategy, q=q,
                     engine_stats=engine.stats_snapshot())
