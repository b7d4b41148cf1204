"""Evaluation planning: shape buckets and pad-or-shrink scheduling.

Counterpart of ``repro/engine/plan.py`` (plain Python, copied).  The
paper's D-BE batch *shrinks* as restarts converge (§4).  ``EvalPlan`` pads
an active set of k points up to the smallest bucket ≥ k of a geometric
ladder, so the whole shrinking schedule runs through at most
``log2(B)+1`` shapes (what a later CUDA-graph capture keys on) while
wasting at most ~2× padded rows in the worst round (vs B× for pad-to-max
on the tail of the schedule).

The same plan object also describes q-batch (joint-candidate) layouts: an
evaluation batch is (k, q, D) with q=1 meaning classic single-point
acquisition (shape (k, D), no q axis materialized — backward compatible).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def bucket_ladder(max_batch: int, min_bucket: int = 1) -> Tuple[int, ...]:
    """Geometric (power-of-two) bucket sizes covering [1, max_batch].

    Always contains ``max_batch`` itself so the opening full-batch rounds
    never pad.  E.g. max_batch=10 → (1, 2, 4, 8, 10).
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder = []
    b = max(min_bucket, 1)
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


@dataclass(frozen=True)
class EvalPlan:
    """Static description of one acquisition-evaluation workload.

    Hashable and immutable.

    Attributes:
      max_batch: B, the number of restarts (upper bound on active set).
      dim: D, the search-space dimension.
      q: joint-candidate count (1 = classic single-point acquisition).
      buckets: allowed padded batch sizes, ascending; every evaluation is
        padded up to the smallest bucket that fits its active set.
    """
    max_batch: int
    dim: int
    q: int = 1
    buckets: Tuple[int, ...] = ()

    @classmethod
    def for_batch(cls, max_batch: int, dim: int, *, q: int = 1,
                  bucketed: bool = True) -> "EvalPlan":
        """Standard plan: geometric ladder, or fixed pad-to-max when
        ``bucketed=False`` (the seed repo's behaviour, kept measurable)."""
        buckets = bucket_ladder(max_batch) if bucketed else (max_batch,)
        return cls(max_batch=max_batch, dim=dim, q=q, buckets=buckets)

    def __post_init__(self):
        if self.q < 1:
            raise ValueError(f"q must be >= 1, got {self.q}")
        if not self.buckets:
            object.__setattr__(self, "buckets", (self.max_batch,))
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} cannot hold "
                f"max_batch={self.max_batch}")

    def bucket_for(self, k: int) -> int:
        """Smallest bucket that holds an active set of ``k`` points."""
        if k < 1 or k > self.max_batch:
            raise ValueError(f"active-set size {k} outside [1, "
                             f"{self.max_batch}]")
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    @property
    def point_shape(self) -> Tuple[int, ...]:
        """Trailing shape of one candidate: (D,) or (q, D)."""
        return (self.dim,) if self.q == 1 else (self.q, self.dim)

    @property
    def flat_dim(self) -> int:
        """Dimension each QN worker optimizes over (q·D for joint mode)."""
        return self.q * self.dim
