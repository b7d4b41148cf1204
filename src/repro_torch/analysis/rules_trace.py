"""recompile-hazard: "never key a program on live studies".

Counterpart of the reference's ``RecompileHazardRule``
(``repro/analysis/rules_trace.py``); its host-leak rule has no
counterpart (the port traces nothing).  The port runs eagerly, but a
:class:`~repro_torch.engine.cache.CountingJit` signature is what a
program would key on (a CUDA-graph capture here, an executable in the
reference): it may depend on the padded shape bucket and slot count,
never on live-study count, occupancy, tenancy/QoS state or mesh
placement, which change every step.  Flagged:

* live-state expressions (``len(self._studies)``, ``self._device_
  occupancy()``, a bare ``self._rung`` …) appearing *as arguments* to a
  counted program — each new value is a new signature;
* functions handed to ``CountingJit`` whose bodies read live scheduler
  state (closure capture bakes it into the program);
* ``CountingJit`` wrappers constructed outside ``__init__``/module scope
  (warning: a per-call wrapper defeats the count entirely).

A program is a name bound to a ``CountingJit(...)`` call, also when the
call is wrapped (the fleet binds ``ProgramTimer(CountingJit(...))``).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import (Finding, ModuleInfo, Project, Rule, call_target,
                   dotted_name)

# host scheduler / service state a program may never be keyed on
LIVE_STATE_ATTRS = {
    "_studies", "_queue", "_blocks", "samplers", "_delayed", "_tenants",
    "trials", "studies", "queue", "_rung", "deficit", "pending",
    "_lat", "n_live",
}
LIVE_STATE_CALLS = {"_device_occupancy", "queue_depth", "live_studies"}

_WRAPPERS = ("CountingJit", "jit")


def _jit_registry(module: ModuleInfo) -> Set[str]:
    """Names bound to CountingJit/jax.jit objects in this module, bare or
    inside a wrapper call."""
    out: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if any(isinstance(n, ast.Call) and call_target(n) in _WRAPPERS
                   for n in ast.walk(node.value)):
                for t in node.targets:
                    name = t.attr if isinstance(t, ast.Attribute) else (
                        t.id if isinstance(t, ast.Name) else None)
                    if name:
                        out.add(name)
    return out


def _live_state_expr(node: ast.AST) -> Optional[str]:
    """Describe the first live-state read inside ``node``, if any."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            tgt = call_target(n)
            if tgt in LIVE_STATE_CALLS:
                return f"{dotted_name(n.func) or tgt}()"
        if isinstance(n, ast.Attribute) and n.attr in LIVE_STATE_ATTRS:
            par = getattr(n, "_parent", None)
            if isinstance(par, ast.Attribute):
                continue
            return dotted_name(n) or n.attr
    return None


class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    severity = "error"
    doc = ("program signatures must not derive from live-study count, "
           "occupancy, tenancy, or mesh placement")

    def run(self, module: ModuleInfo, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        registry = _jit_registry(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            tgt = call_target(node)
            qual = project.enclosing_function(node)
            if tgt in registry and tgt not in _WRAPPERS:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    desc = _live_state_expr(arg)
                    if desc is not None:
                        findings.append(module.finding(
                            self, arg,
                            f"argument derives from live scheduler state "
                            f"({desc}) in call to jit program {tgt} — "
                            f"cache key must not depend on live studies",
                            func=qual))
            if tgt in _WRAPPERS:
                # closure capture of live state by the wrapped fn
                if node.args:
                    for fi in project.resolve(node.args[0], module):
                        desc = _live_state_expr(fi.node)
                        if desc is not None:
                            findings.append(module.finding(
                                self, node,
                                f"function {fi.qualname} passed to {tgt} "
                                f"reads live scheduler state ({desc}); "
                                f"closure capture bakes it into the "
                                f"compiled program",
                                func=qual))
                # construction site discipline
                encl = qual.rsplit(".", 1)[-1] if qual else ""
                if qual and encl != "__init__" \
                        and not encl.startswith(("_build", "_make", "make_")):
                    findings.append(module.finding(
                        self, node,
                        f"{tgt} constructed inside {qual}; per-call jit "
                        f"wrappers defeat the compile cache — build "
                        f"programs once in __init__/module scope",
                        func=qual, severity="warning"))
        return findings
