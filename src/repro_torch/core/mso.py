"""Multi-start acquisition-function optimization: the paper's Algorithm 1/2.

Counterpart of ``repro/core/mso.py`` for the scipy-driven strategies:

* ``seq``  — SEQ. OPT.: B sequential scipy L-BFGS-B runs (Algorithm 2).
* ``cbe``  — C-BE: one scipy L-BFGS-B over the flattened (B·D,) summed
             objective (off-diagonal artifacts).
* ``dbe``  — D-BE (paper): coroutine-decoupled scipy workers + batched
             evaluation, shrinking active set.
* ``dbe_vec`` — D-BE vectorized: the batched L-BFGS-B of ``core.lbfgsb``
             on the device, all restarts in one lockstep loop.

All strategies *maximize* the acquisition (internally minimizing its
negation) and route every evaluation through one
:class:`~repro_torch.engine.engine.EvalEngine`; they differ only in who
drives the quasi-Newton updates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import coroutine as co
from repro_torch.core.lbfgsb import LbfgsbOptions
from repro_torch.engine.engine import EvalEngine, default_engine
from repro_torch.engine.plan import EvalPlan

STRATEGIES = ("seq", "cbe", "dbe", "dbe_vec")

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


def mso_result_from_lockstep(res, x0_shape, wall: float, *, q: int = 1,
                             engine_stats: Optional[dict] = None
                             ) -> MsoResult:
    """Materialize a device ``LbfgsbResult`` into an :class:`MsoResult`
    (the ``dbe_vec`` branch of :func:`maximize_acqf`)."""
    acq = -res.f.cpu().numpy()
    best = int(np.argmax(acq))
    xs = res.x.cpu().numpy().reshape(x0_shape)
    return MsoResult(x=xs, acq=acq, best_x=xs[best],
                     best_acq=float(acq[best]), n_iters=res.k.cpu().numpy(),
                     n_evals=res.n_evals.cpu().numpy(),
                     n_rounds=int(res.rounds), wall_time=wall,
                     strategy="dbe_vec", q=q, engine_stats=engine_stats)


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
    tensors, or, for a state with no tensor (``None``, as a plain
    objective has), the process-wide :func:`default_engine` of ``acq_fn``
    on the card.  On the CPU pass ``engine=default_engine(acq_fn, "cpu")``
    or ``engine=EvalEngine(acq_fn, "cpu")``.
    """
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
        engine = (default_engine(acq_fn) if dev is None
                  else EvalEngine(acq_fn, device=dev))

    # flat (B, q·D) view for the QN solvers; bounds tile across the q axis
    x0f = x0.reshape(B, plan.flat_dim)
    lower = np.broadcast_to(np.asarray(lower, np.float64), (D,))
    upper = np.broadcast_to(np.asarray(upper, np.float64), (D,))
    lowf = np.tile(lower, q)
    upf = np.tile(upper, q)

    if strategy == "dbe_vec":
        opts = LbfgsbOptions(m=options.m, maxiter=options.maxiter,
                             pgtol=options.pgtol, ftol=options.ftol,
                             maxls=options.maxls)

        def dev(a):
            return torch.tensor(np.broadcast_to(a, x0f.shape),
                                dtype=torch.float64).to(engine.device)

        t0 = time.perf_counter()
        res = engine.run_lockstep(acq_state, dev(x0f), dev(lowf), dev(upf),
                                  opts, plan)
        wall = time.perf_counter() - t0
        return mso_result_from_lockstep(res, x0.shape, wall, q=q,
                                        engine_stats=engine.stats_snapshot())

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


def closure_engine(acq_batched, device=None) -> EvalEngine:
    """A reusable :class:`EvalEngine` for a plain closure ``X -> (k,)``,
    tagged with its source closure so :func:`maximize_acqf_closure` can
    check that an engine it is handed evaluates that closure.  ``device``
    follows the entry-point rule (``None``: the card)."""
    def fn(state, X):
        del state
        return acq_batched(X)
    fn.__wrapped_closure__ = acq_batched
    return EvalEngine(fn, device=device)


def maximize_acqf_closure(acq_batched, x0, lower, upper, *,
                          strategy="dbe", options=None, q=1, engine=None):
    """:func:`maximize_acqf` for a plain closure ``X -> (k,)``.

    Every call wraps ``acq_batched`` in a fresh state-form function, so
    without ``engine`` each call builds its own (card) engine; pass
    ``engine=closure_engine(acq_batched)``, built once, to share one
    across calls (on the CPU: ``closure_engine(acq_batched, "cpu")``).
    An engine evaluates its own captured ``acq_fn``, so one built from a
    different closure would maximize the wrong acquisition: it is
    rejected.
    """
    if engine is not None:
        src = getattr(engine.acq_fn, "__wrapped_closure__", None)
        if src is not acq_batched and engine.acq_fn is not acq_batched:
            raise ValueError(
                "engine= was built from a different closure than "
                "acq_batched (the engine evaluates its own acq_fn); "
                "build it with closure_engine(acq_batched)")

    def fn(state, X):
        del state
        return acq_batched(X)
    return maximize_acqf(fn, x0, lower, upper, acq_state=None,
                         strategy=strategy, options=options, q=q,
                         engine=engine)
