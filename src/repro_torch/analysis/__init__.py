"""Runtime sanitizers of the port: the opt-in NaN guard for the fleet
block programs and the solo AskEngine programs
(:mod:`repro_torch.analysis.runtime`).  The reference's static invariant
linter (``python -m repro.analysis``) has no counterpart here yet.
"""
from .runtime import (FiniteGuard, NonFiniteError, install_nan_guard,
                      nan_guard_stats)

__all__ = ["FiniteGuard", "NonFiniteError", "install_nan_guard",
           "nan_guard_stats"]
