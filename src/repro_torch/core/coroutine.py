"""Paper-faithful coroutine D-BE on top of *unmodified* scipy L-BFGS-B
(copied from ``repro/core/coroutine.py``: numpy and scipy only).

The paper (§4, "Decouple L-BFGS-B Updates by Coroutine") realizes D-BE with
one *batch evaluator* plus ``B`` *worker* coroutines, each a suspended
L-BFGS-B solver.  scipy's public ``minimize`` offers no per-iteration hook,
but its reverse-communication core ``_lbfgsb.setulb`` is exactly a coroutine:
it returns to the caller whenever it needs ``(f, g)`` at a point and resumes
from the same internal state.  We wrap each solver instance in a Python
generator (``lbfgsb_worker``) that *yields* evaluation requests and
*receives* results — cooperative multitasking as in the paper — and drive all
workers round-by-round with one batched device evaluation per round.

Task codes of scipy>=1.15's C ``setulb`` (verified empirically):
  3 = FG   (evaluate objective+gradient at ``x``)
  1 = NEW_X (one QN iteration finished)
  2/4 = converged, 5 = user stop, anything else = error/stop.

scipy<1.15 ships the original Fortran ``setulb`` whose task channel is a
60-char string ('FG...', 'NEW_X', 'CONV...'); ``_SetulbDriver`` adapts both
APIs to the integer codes above so the worker logic is version-agnostic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Generator, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import _lbfgsb

_TASK_FG = 3
_TASK_NEW_X = 1
_TASK_CONV = 2
_TASK_STOP = 5
_TASK_ERROR = 99

# scipy>=1.15 rewrote setulb in C with integer task codes and no
# iprint/csave; detect which ABI this interpreter has once at import.
_HAS_C_SETULB = "iprint" not in (_lbfgsb.setulb.__doc__ or "iprint")


class _SetulbDriver:
    """Reverse-communication L-BFGS-B adapted to one integer task code.

    Owns the solver workspace for one restart; ``step()`` advances the
    underlying ``setulb`` once and returns one of the ``_TASK_*`` codes.
    ``x``/``f``/``g`` are the live in/out buffers (f and g must be written
    by the caller before the step that follows a ``_TASK_FG``).
    """

    def __init__(self, x0, low, up, nbd, m, factr, pgtol, maxls):
        n = x0.size
        self.m, self.factr, self.pgtol, self.maxls = m, factr, pgtol, maxls
        self.x = x0
        self.f = np.array(0.0, np.float64)
        self.g = np.zeros(n, np.float64)
        self.low, self.up, self.nbd = low, up, nbd
        self.wa = np.zeros(2 * m * n + 5 * n + 11 * m * m + 8 * m,
                           np.float64)
        self.iwa = np.zeros(3 * n, np.int32)
        self.lsave = np.zeros(4, np.int32)
        self.isave = np.zeros(44, np.int32)
        self.dsave = np.zeros(29, np.float64)
        if _HAS_C_SETULB:
            self.task = np.zeros(2, np.int32)
            self.ln_task = np.zeros(2, np.int32)
        else:
            self.task = np.zeros(1, "S60")
            self.task[:] = b"START"
            self.csave = np.zeros(1, "S60")

    def step(self) -> int:
        if _HAS_C_SETULB:
            _lbfgsb.setulb(self.m, self.x, self.low, self.up, self.nbd,
                           self.f, self.g, self.factr, self.pgtol, self.wa,
                           self.iwa, self.task, self.lsave, self.isave,
                           self.dsave, self.maxls, self.ln_task)
            t = int(self.task[0])
            if t in (_TASK_FG, _TASK_NEW_X, _TASK_CONV, 4, _TASK_STOP):
                return _TASK_CONV if t == 4 else t
            return _TASK_ERROR
        _lbfgsb.setulb(self.m, self.x, self.low, self.up, self.nbd,
                       self.f, self.g, self.factr, self.pgtol, self.wa,
                       self.iwa, self.task, -1, self.csave, self.lsave,
                       self.isave, self.dsave, self.maxls)
        t = self.task.tobytes()
        if t.startswith(b"FG"):
            return _TASK_FG
        if t.startswith(b"NEW_X"):
            return _TASK_NEW_X
        if t.startswith(b"CONV"):
            return _TASK_CONV
        if t.startswith(b"STOP"):
            return _TASK_STOP
        return _TASK_ERROR

EvalRequest = np.ndarray          # the point the worker wants evaluated
EvalResult = Tuple[float, np.ndarray]


@dataclass
class WorkerStats:
    n_iters: int = 0              # L-BFGS-B iterations (NEW_X events)
    n_evals: int = 0              # objective/gradient evaluations
    status: str = "running"
    x: Optional[np.ndarray] = None
    f: float = np.inf


def lbfgsb_worker(
    x0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    *,
    m: int = 10,
    maxiter: int = 200,
    pgtol: float = 1e-5,
    factr: float = 0.0,
    maxls: int = 25,
    stats: Optional[WorkerStats] = None,
) -> Generator[EvalRequest, EvalResult, WorkerStats]:
    """One restart as a coroutine: ``yield x`` → receive ``(f, g)``.

    The underlying solver is scipy's L-BFGS-B, unmodified; this generator is
    the paper's "worker".  It terminates (StopIteration) when the solver
    converges or hits ``maxiter``; ``stats`` carries the outcome.
    """
    n = x0.size
    st = stats if stats is not None else WorkerStats()
    x = np.clip(np.asarray(x0, np.float64).copy(), lower, upper)
    nbd = np.full(n, 2, np.int32)          # both-sided bounds (BO boxes)
    low = np.ascontiguousarray(
        np.broadcast_to(np.asarray(lower, np.float64), (n,)))
    up = np.ascontiguousarray(
        np.broadcast_to(np.asarray(upper, np.float64), (n,)))
    drv = _SetulbDriver(x, low, up, nbd, m, factr, pgtol, maxls)

    while True:
        t = drv.step()
        if t == _TASK_FG:
            fv, gv = yield x              # suspend; evaluator resumes us
            drv.f = np.array(fv, np.float64)
            # hard copy: gv may be a read-only view of a device buffer,
            # but setulb takes g as intent(inout)
            drv.g = np.array(gv, np.float64, copy=True)
            st.n_evals += 1
        elif t == _TASK_NEW_X:
            st.n_iters += 1
            if st.n_iters >= maxiter:
                st.status = "maxiter"
                break
        else:
            st.status = "converged" if t == _TASK_CONV else f"stop({t})"
            break
    st.x = x.copy()
    st.f = float(drv.f)
    return st


BatchEvalFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
# (k, D) -> ((k,) f, (k, D) g)


@dataclass
class MultistartOutcome:
    x: np.ndarray                 # (B, D) final per-restart points
    f: np.ndarray                 # (B,)   final per-restart values (min scale)
    n_iters: np.ndarray           # (B,)
    n_evals: np.ndarray           # (B,)   per-restart objective evals
    n_rounds: int                 # batched evaluation rounds
    batch_sizes: List[int] = field(default_factory=list)
    wall_time: float = 0.0


def run_dbe_coroutine(
    batch_eval: BatchEvalFn,
    x0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    **worker_opts,
) -> MultistartOutcome:
    """D-BE: decoupled per-restart QN updates, batched evaluations.

    Algorithm 1's right column.  Maintains the active set A of ongoing
    restarts; converged workers are pruned so the evaluation batch shrinks
    progressively (paper §4).
    """
    t0 = time.perf_counter()
    B, D = x0.shape
    stats = [WorkerStats() for _ in range(B)]
    workers: List[Optional[Generator]] = []
    pending: List[Optional[np.ndarray]] = []
    for b in range(B):
        w = lbfgsb_worker(x0[b], lower, upper, stats=stats[b], **worker_opts)
        try:
            req = next(w)                 # prime: first FG request
            workers.append(w)
            pending.append(req.copy())
        except StopIteration:
            workers.append(None)
            pending.append(None)

    n_rounds = 0
    batch_sizes: List[int] = []
    while True:
        active = [b for b in range(B) if workers[b] is not None]
        if not active:
            break
        X = np.stack([pending[b] for b in active])       # (|A|, D)
        fs, gs = batch_eval(X)                           # one batched call
        n_rounds += 1
        batch_sizes.append(len(active))
        for i, b in enumerate(active):
            try:
                req = workers[b].send((float(fs[i]), np.asarray(gs[i])))
                pending[b] = req.copy()
            except StopIteration:
                workers[b] = None
                pending[b] = None

    return MultistartOutcome(
        x=np.stack([s.x for s in stats]),
        f=np.array([s.f for s in stats]),
        n_iters=np.array([s.n_iters for s in stats]),
        n_evals=np.array([s.n_evals for s in stats]),
        n_rounds=n_rounds,
        batch_sizes=batch_sizes,
        wall_time=time.perf_counter() - t0,
    )


def run_seq_opt(
    batch_eval: BatchEvalFn,
    x0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    **worker_opts,
) -> MultistartOutcome:
    """SEQ. OPT. (Algorithm 2): restarts one after another, no batching.

    Evaluations go through the same ``batch_eval`` with k=1, so the only
    difference from D-BE is the absence of cross-restart batching — exactly
    the paper's control condition.
    """
    t0 = time.perf_counter()
    B, D = x0.shape
    stats = [WorkerStats() for _ in range(B)]
    n_rounds = 0
    for b in range(B):
        w = lbfgsb_worker(x0[b], lower, upper, stats=stats[b], **worker_opts)
        try:
            req = next(w)
            while True:
                fs, gs = batch_eval(req[None, :])
                n_rounds += 1
                req = w.send((float(fs[0]), np.asarray(gs[0])))
        except StopIteration:
            pass
    return MultistartOutcome(
        x=np.stack([s.x for s in stats]),
        f=np.array([s.f for s in stats]),
        n_iters=np.array([s.n_iters for s in stats]),
        n_evals=np.array([s.n_evals for s in stats]),
        n_rounds=n_rounds,
        batch_sizes=[1] * n_rounds,
        wall_time=time.perf_counter() - t0,
    )


def run_cbe(
    batch_eval: BatchEvalFn,
    x0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    **worker_opts,
) -> MultistartOutcome:
    """C-BE (BoTorch ≤0.14): ONE L-BFGS-B over the flattened (B·D,) vector
    minimizing ``Σ_b f(x^(b))``.  The shared dense QN state over B·D dims is
    what produces the off-diagonal artifacts."""
    t0 = time.perf_counter()
    B, D = x0.shape
    st = WorkerStats()
    lo = np.broadcast_to(lower, (B, D)).reshape(-1)
    hi = np.broadcast_to(upper, (B, D)).reshape(-1)
    w = lbfgsb_worker(x0.reshape(-1), lo, hi, stats=st, **worker_opts)
    n_rounds = 0
    try:
        req = next(w)
        while True:
            X = req.reshape(B, D)
            fs, gs = batch_eval(X)                       # batched under the hood
            n_rounds += 1
            req = w.send((float(np.sum(fs)), np.asarray(gs).reshape(-1)))
    except StopIteration:
        pass
    Xf = st.x.reshape(B, D)
    fs, _ = batch_eval(Xf)
    return MultistartOutcome(
        x=Xf,
        f=np.asarray(fs),
        n_iters=np.full(B, st.n_iters),
        n_evals=np.full(B, st.n_evals),
        n_rounds=n_rounds,
        batch_sizes=[B] * n_rounds,
        wall_time=time.perf_counter() - t0,
    )
