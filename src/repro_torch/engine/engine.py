"""The acquisition-evaluation engine behind every MSO strategy.

Counterpart of ``repro/engine/engine.py``.  One object owns:

* the single definition of ``(-acq, -∇acq)``: one forward with
  ``requires_grad`` and one ``backward`` per round, never two forwards;
* pad-or-shrink scheduling: the host-facing evaluator pads an active set
  up to its :class:`~repro_torch.engine.plan.EvalPlan` bucket by
  repeating the last row, and slices the results back;
* the evaluation-economy counters (:class:`EngineStats`), including the
  posterior kernels' launches made by this engine's evaluations.

Per round the evaluator makes two host copies: the padded points to the
device, and values and gradients back in one tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.engine.plan import EvalPlan
from repro_torch.kernels.matern.kernel import launch_counts

Tensor = torch.Tensor

# acq_fn(state, X) -> (k,) with X (k, D) [q=1] or (k, q, D) [q>1]
AcqStateFn = Callable[[Any, Tensor], Tensor]
# host-facing batched evaluator: (k, q*D) -> ((k,), (k, q*D))
BatchEvalFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclass
class EngineStats:
    """Evaluation economy counters for one engine."""
    n_rounds: int = 0            # host-facing batched evaluation rounds
    n_points: int = 0            # live points evaluated (excl. padding)
    n_padded: int = 0            # padded rows evaluated and discarded
    bucket_rounds: Dict[int, int] = field(default_factory=dict)
    # kernel launches made while this engine evaluated, by kernel name
    kernel_launches: Dict[str, int] = field(default_factory=dict)

    def count_launches_since(self, before: Dict[str, int]) -> None:
        for name, n in launch_counts().items():
            self.kernel_launches[name] = (self.kernel_launches.get(name, 0)
                                          + n - before.get(name, 0))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "n_rounds": self.n_rounds,
            "n_points": self.n_points,
            "n_padded": self.n_padded,
            "bucket_rounds": dict(self.bucket_rounds),
            "kernel_launches": dict(self.kernel_launches),
        }


class EvalEngine:
    """Batched acquisition evaluation plane behind every MSO strategy.

    ``device`` follows the entry-point rule: ``None`` means the card.
    """

    def __init__(self, acq_fn: AcqStateFn, device=None):
        self.acq_fn = acq_fn
        self.device = resolve_device(device)
        self.stats = EngineStats()

    def _neg_value_and_grad(self, state, X: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            X = X.detach().requires_grad_(True)
            f = -self.acq_fn(state, X)
            # rows are independent, so d(Σf)/dX_r is row r's gradient
            (g,) = torch.autograd.grad(f.sum(), X)
        return f.detach(), g

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
            f, g = self._neg_value_and_grad(state, Xd)
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
        return self.stats.snapshot()
