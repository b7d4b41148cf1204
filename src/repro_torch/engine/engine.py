"""The acquisition-evaluation engine behind every MSO strategy.

Counterpart of ``repro/engine/engine.py``.  One object owns:

* the single definition of ``(-acq, -∇acq)``: one forward with
  ``requires_grad`` and one ``backward`` per round, never two forwards;
* pad-or-shrink scheduling: the host-facing evaluator pads an active set
  up to its :class:`~repro_torch.engine.plan.EvalPlan` bucket by
  repeating the last row, and slices the results back;
* the lockstep entry (``dbe_vec``): :meth:`EvalEngine.run_lockstep` runs
  the whole multi-start solve on the device through :meth:`device_fun`,
  which the fused ask pipeline (``engine/ask.py``) also consumes;
* the evaluation-economy counters (:class:`EngineStats`), including the
  kernel launches made by this engine's evaluations, and the program
  counts of :class:`~repro_torch.engine.cache.CountingJit`.

Per round the host-facing evaluator makes two host copies: the padded
points to the device, and values and gradients back in one tensor.  The
lockstep solve makes none per round (its loop condition is one host sync).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lbfgsb import LbfgsbOptions, LbfgsbResult, \
    lbfgsb_minimize
from repro_torch.engine.cache import CountingJit, retrace_report
from repro_torch.engine.plan import EvalPlan
from repro_torch.kernels.matern.kernel import launch_counts
from repro_torch.obs import trace as obs

Tensor = torch.Tensor

# acq_fn(state, X) -> (k,) with X (k, D) [q=1] or (k, q, D) [q>1]
AcqStateFn = Callable[[Any, Tensor], Tensor]
# host-facing batched evaluator: (k, q*D) -> ((k,), (k, q*D))
BatchEvalFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclass
class EngineStats:
    """Evaluation economy counters for one engine."""
    n_rounds: int = 0            # batched evaluation rounds
    n_points: int = 0            # live points evaluated (excl. padding)
    n_padded: int = 0            # padded rows evaluated and discarded
    n_refit_fallbacks: int = 0   # incremental refits demoted to full
    bucket_rounds: Dict[int, int] = field(default_factory=dict)
    # kernel launches made while this engine evaluated (and while an ask
    # program that drives it ran), by kernel name
    kernel_launches: Dict[str, int] = field(default_factory=dict)

    def count_launches_since(self, before: Dict[str, int]) -> None:
        for name, n in launch_counts().items():
            self.kernel_launches[name] = (self.kernel_launches.get(name, 0)
                                          + n - before.get(name, 0))

    def snapshot(self, engine: "EvalEngine") -> Dict[str, Any]:
        return {
            "n_compiles": engine.n_compiles,
            "n_eval_compiles": engine._eval_prog.n_compiles,
            "n_lockstep_compiles": engine._vec_prog.n_compiles,
            "n_rounds": self.n_rounds,
            "n_points": self.n_points,
            "n_padded": self.n_padded,
            "n_refit_fallbacks": self.n_refit_fallbacks,
            "bucket_rounds": dict(self.bucket_rounds),
            "kernel_launches": dict(self.kernel_launches),
            "retraces": retrace_report({"eval": engine._eval_prog,
                                        "lockstep": engine._vec_prog}),
        }


class EvalEngine:
    """Batched acquisition evaluation plane behind every MSO strategy.

    ``device`` follows the entry-point rule: ``None`` means the card.
    """

    def __init__(self, acq_fn: AcqStateFn, device=None):
        self.acq_fn = acq_fn
        self.device = resolve_device(device)
        self.stats = EngineStats()
        self._eval_prog = CountingJit(self._neg_value_and_grad, name="eval")

        def _run_lockstep(state, x0, lower, upper, opts: LbfgsbOptions,
                          plan: EvalPlan):
            fun = self.device_fun(state, plan)
            return lbfgsb_minimize(fun, x0, lower, upper, opts)

        self._vec_prog = CountingJit(_run_lockstep, static_argnums=(4, 5),
                                     name="lockstep")
        # device-completion timing; passthrough with tracing off
        self._eval_prog = obs.ProgramTimer(self._eval_prog,
                                           "engine.program.eval")
        self._vec_prog = obs.ProgramTimer(self._vec_prog,
                                          "engine.program.lockstep")

    @property
    def n_compiles(self) -> int:
        """Programs issued by this engine (new input signatures, all entry
        points)."""
        return self._eval_prog.n_compiles + self._vec_prog.n_compiles

    def _neg_value_and_grad(self, state, X: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            X = X.detach().requires_grad_(True)
            f = -self.acq_fn(state, X)
            # rows are independent, so d(Σf)/dX_r is row r's gradient
            (g,) = torch.autograd.grad(f.sum(), X)
        return f.detach(), g

    # ------------------------------------------------------------- device
    def device_fun(self, state, plan: EvalPlan):
        """Batched ``(B, q·D) → ((B,), (B, q·D))`` evaluation for the
        lockstep solver, on device tensors (also consumed by the fused ask
        pipeline in ``engine/ask.py``).  One forward and one backward a
        call: on the card one K1 and one K2 launch."""

        def fun_batched(X: Tensor) -> Tuple[Tensor, Tensor]:
            f, g = self._neg_value_and_grad(
                state, X.reshape((X.shape[0],) + plan.point_shape))
            return f, g.reshape(X.shape)

        return fun_batched

    def fleet_device_fun(self, states, plan: EvalPlan):
        """Batched ``(S, B, q·D) → ((S, B), (S, B, q·D))`` evaluation for
        the fleet's leading-batch lockstep solver.

        ``states = (gp, best)`` holds S studies' acquisition states stacked
        along a leading study axis (every tensor of the
        :class:`~repro_torch.gp.gpr.GPState` leads with S; ``best`` is
        (S,)): row s of the batch is scored against study s.  One forward
        and one backward a call, so on the card one K1 and one K2 launch
        for every study of the block (JAX vmaps the acquisition instead).
        """
        gp, best = states
        state = (gp, best[:, None])

        def fun_batched(X: Tensor) -> Tuple[Tensor, Tensor]:
            f, g = self._neg_value_and_grad(
                state, X.reshape(X.shape[:2] + plan.point_shape))
            return f, g.reshape(X.shape)

        return fun_batched

    def run_lockstep(self, state, x0: Tensor, lower: Tensor, upper: Tensor,
                     opts: LbfgsbOptions, plan: EvalPlan) -> LbfgsbResult:
        """dbe_vec: the whole multi-start solve on the device (masked
        lockstep active set; one host sync per loop condition)."""
        before = launch_counts()
        res = self._vec_prog(state, x0, lower, upper, opts, plan)
        self.stats.count_launches_since(before)
        self.record_lockstep_economy(x0.shape[0], res.rounds, res.n_evals)
        return res

    def record_lockstep_economy(self, B: int, rounds, n_evals) -> None:
        """Surface a device lockstep solve's evaluation economy into
        EngineStats: every device round evaluates the full (frozen rows
        included) B-batch, so rounds·B − Σ active-evals is the padding
        analogue.  Called by :meth:`run_lockstep` and the fused ask."""
        rounds = int(rounds)
        evals = int(torch.as_tensor(n_evals).sum())
        self.stats.n_rounds += rounds
        self.stats.n_points += evals
        self.stats.n_padded += rounds * B - evals
        self.stats.bucket_rounds[B] = \
            self.stats.bucket_rounds.get(B, 0) + rounds

    def record_refit_fallback(self) -> None:
        """An incremental (rank-one) refit failed its Schur-complement
        soundness check and was demoted to a full MAP refit.  Called by
        ``AskEngine.suggest``."""
        self.stats.n_refit_fallbacks += 1

    def evaluator(self, state, plan: EvalPlan) -> BatchEvalFn:
        """numpy-facing batched ``(-acq, -∇acq)`` evaluator for the scipy
        coroutine strategies.

        Pads each request up to ``plan.bucket_for(k)`` (repeating the last
        row; values at real points are unaffected), evaluates once on the
        device, and slices the first k results back out.
        """

        def batch_eval(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
            k = X.shape[0]
            b = plan.bucket_for(k)
            if b > k:
                X = np.concatenate([X, np.repeat(X[-1:], b - k, 0)], 0)
            Xd = torch.as_tensor(np.ascontiguousarray(X, np.float64)).to(
                self.device).reshape((b,) + plan.point_shape)
            before = launch_counts()
            f, g = self._eval_prog(state, Xd)
            fg = torch.cat([f[:, None], g.reshape(b, -1)], 1).cpu().numpy()
            self.stats.count_launches_since(before)
            self.stats.n_rounds += 1
            self.stats.n_points += k
            self.stats.n_padded += b - k
            self.stats.bucket_rounds[b] = \
                self.stats.bucket_rounds.get(b, 0) + 1
            return fg[:k, 0], fg[:k, 1:]

        return batch_eval

    def values(self, state, X, plan: EvalPlan = None) -> np.ndarray:
        """Acquisition values (maximization scale) at ``(k, ...)`` points,
        without gradients: for re-ranking a candidate pool or inspecting a
        surface."""
        Xd = torch.as_tensor(np.asarray(X, np.float64)).to(self.device)
        if plan is not None:
            Xd = Xd.reshape((Xd.shape[0],) + plan.point_shape)
        before = launch_counts()
        with torch.no_grad():
            out = self.acq_fn(state, Xd).cpu().numpy()
        self.stats.count_launches_since(before)
        return out

    def stats_snapshot(self) -> Dict[str, Any]:
        return self.stats.snapshot(self)


# Casual callers (examples, one-off maximize_acqf calls with no tensor in
# their state) get a process-wide engine per acquisition function and
# device, as the reference does, without threading engine objects through
# every call site.
_DEFAULT_ENGINES: "weakref.WeakKeyDictionary[Callable, Dict]" = \
    weakref.WeakKeyDictionary()


def default_engine(acq_fn: AcqStateFn, device=None) -> EvalEngine:
    """The process-wide :class:`EvalEngine` of ``acq_fn`` on ``device``
    (``None`` means the card, as for every entry point)."""
    dev = resolve_device(device)
    engines = _DEFAULT_ENGINES.get(acq_fn)
    eng = None if engines is None else engines.get(dev)
    if eng is None:
        eng = EvalEngine(acq_fn, device=dev)
        try:
            _DEFAULT_ENGINES.setdefault(acq_fn, {})[dev] = eng
        except TypeError:          # not weak-referenceable: no cache
            pass
    return eng
