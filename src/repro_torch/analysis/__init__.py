"""Static invariant linter and runtime sanitizers of the port.

``python -m repro_torch.analysis`` runs the AST rule families of the
reference's linter (``python -m repro.analysis``) that apply to eager
PyTorch:

* ``wal-before-state``      — journal append dominates the state change
* ``recompile-hazard``      — program signatures never derive from live
  studies, occupancy, tenancy or mesh placement

Three reference rules are left out, each for a reason of the port:

* ``use-after-donate``: the port donates nothing (``engine/ask.py``:
  its programs update their holders' tensors, no buffer is handed over);
* ``host-leak-into-trace`` and ``nan-hazard``: both walk the closures of
  ``jit`` and ``lax.while_loop`` roots, and the port traces nothing —
  its loops are Python loops on the host by design, and its benign-row
  finiteness is held at run time by the NaN guard below.

The runtime half is :mod:`repro_torch.analysis.runtime` (the opt-in NaN
guard for the fleet block programs and the solo AskEngine programs) and
:class:`repro_torch.engine.cache.CountingJit`'s retrace classifier.
"""
from .baseline import Baseline
from .core import Finding, Project, Rule, load_project
from .report import Report, run_rules
from .rules_trace import RecompileHazardRule
from .rules_wal import WalBeforeStateRule
from .runtime import (FiniteGuard, NonFiniteError, install_nan_guard,
                      nan_guard_stats)

#: the registered rule set, in documentation order
ALL_RULES = (
    WalBeforeStateRule(),
    RecompileHazardRule(),
)

RULE_IDS = tuple(r.id for r in ALL_RULES)

__all__ = [
    "ALL_RULES", "RULE_IDS", "Baseline", "Finding", "Project", "Report",
    "Rule", "load_project", "run_rules", "RecompileHazardRule",
    "WalBeforeStateRule", "FiniteGuard", "NonFiniteError",
    "install_nan_guard", "nan_guard_stats",
]
