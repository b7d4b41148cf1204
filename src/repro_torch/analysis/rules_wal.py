"""wal-before-state: journal records must dominate the state they cover.

Counterpart of ``repro/analysis/rules_wal.py``, unchanged: the port's
fleet (``engine/fleet.py``), BO service (``serve/bo_service.py``) and
fleet sampler (``bo/sampler.py``) journal through the same
``self._journal(...)`` / ``*.journal.append(...)`` idioms.

The WAL contract (ROADMAP: durability invariants) is *append the record,
then mutate*: recovery replays the journal through the normal paths, so
any host-state transition that lands before its record can be observed
by a crash that the journal never heard about.

Scope: only functions that *directly* contain a journal append — a call
to ``self._journal(...)`` or ``*.journal.append(...)`` — excluding
``__init__`` (constructors journal their own config record after field
setup by design).  Within such a function, every *tracked mutation* must
be dominated by a journal call on its control-flow path:

* attribute stores to journaled scalar state
  (``state``/``shed``/``parked``/``degraded``/``not_before``/``_rung``)
* destructive container ops (``pop``/``popleft``/``remove``/``clear``)
  on journaled containers (``xs``/``ys``/``tags``/``trials``/``queue``/
  ``_queue``/``_delayed``/``studies``)
* growth ops (``append``/``appendleft``/``extend``) on scheduler
  containers (``trials``/``queue``/``_queue``/``_delayed``) — but *not*
  on per-study observation lists, whose WAL lives in the caller's tell
  record
* slot installs (``blk.studies[slot] = ...``) and calls to the compound
  mutators ``self._evict`` / ``self._clear_slot``

Dominance is computed by a suite walk: a branch that terminates
(return/raise) does not propagate its journal flag past the statement;
loop bodies are checked but never propagate (they may run zero times).
An ``if <...journal...>:`` guard around the append itself (the optional-
journal idiom) counts as dominating the fall-through.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from .core import (Finding, ModuleInfo, Project, Rule, call_target,
                   dotted_name, last_segment)

SCALAR_ATTRS = {"state", "shed", "parked", "degraded", "not_before",
                "_rung"}
DESTRUCTIVE_OPS = {"pop", "popleft", "remove", "clear"}
DESTRUCTIVE_CONTAINERS = {"xs", "ys", "tags", "trials", "queue", "_queue",
                          "_delayed", "studies"}
GROWTH_OPS = {"append", "appendleft", "extend"}
GROWTH_CONTAINERS = {"trials", "queue", "_queue", "_delayed"}
SUBSCRIPT_CONTAINERS = {"studies"}
COMPOUND_MUTATORS = {"_evict", "_clear_slot"}


def is_journal_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr == "_journal":
            return True
        if fn.attr == "append":
            base = last_segment(fn.value)
            if base is not None and "journal" in base:
                return True
    return False


def _stmt_has_journal(stmt: ast.stmt) -> bool:
    return any(is_journal_call(n) for n in ast.walk(stmt))


def _mutation_in_expr(node: ast.AST) -> Optional[Tuple[ast.AST, str]]:
    """First tracked mutation inside an expression tree (calls only)."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        tgt = call_target(n)
        if tgt in COMPOUND_MUTATORS:
            return n, f"call to {dotted_name(n.func) or tgt}()"
        if isinstance(n.func, ast.Attribute):
            recv = last_segment(n.func.value)
            if (tgt in DESTRUCTIVE_OPS and recv in DESTRUCTIVE_CONTAINERS):
                return n, f"{recv}.{tgt}() on journaled container"
            if tgt in GROWTH_OPS and recv in GROWTH_CONTAINERS:
                return n, f"{recv}.{tgt}() on journaled container"
    return None


def _mutations_in_stmt(stmt: ast.stmt) -> List[Tuple[ast.AST, str]]:
    out: List[Tuple[ast.AST, str]] = []
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            for el in elts:
                if isinstance(el, ast.Attribute) and el.attr in SCALAR_ATTRS:
                    out.append((el, f"store to .{el.attr}"))
                if (isinstance(el, ast.Subscript)
                        and isinstance(el.value, ast.Attribute)
                        and el.value.attr in SUBSCRIPT_CONTAINERS):
                    out.append((el, f"slot store to .{el.value.attr}[...]"))
        value = stmt.value
        if value is not None:
            m = _mutation_in_expr(value)
            if m:
                out.append(m)
    elif isinstance(stmt, ast.Expr):
        m = _mutation_in_expr(stmt.value)
        if m:
            out.append(m)
    return out


def _terminates(stmt: ast.stmt) -> bool:
    return isinstance(stmt, (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _journal_guard_test(test: ast.AST) -> bool:
    """``if self.journal is not None:`` / ``if journal:`` style guards."""
    for n in ast.walk(test):
        name = last_segment(n) if isinstance(n, (ast.Name, ast.Attribute)) \
            else None
        if name is not None and "journal" in name:
            return True
    return False


class WalBeforeStateRule(Rule):
    id = "wal-before-state"
    severity = "error"
    doc = ("journaled host-state mutations must be dominated by their "
           "journal append (WAL ordering)")

    def run(self, module: ModuleInfo, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name == "__init__":
                continue
            if not any(is_journal_call(n) for n in ast.walk(node)):
                continue
            fi = project.func_for_node(node)
            qual = fi.qualname if fi else node.name
            self._check_suite(node.body, False, module, qual, findings)
        return findings

    # returns (journaled_after, terminated)
    def _check_suite(self, stmts, journaled: bool, module: ModuleInfo,
                     qual: str, findings: List[Finding]
                     ) -> Tuple[bool, bool]:
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                jb, tb = self._check_suite(stmt.body, journaled, module,
                                           qual, findings)
                jo, to = self._check_suite(stmt.orelse, journaled, module,
                                           qual, findings)
                if not stmt.orelse and _journal_guard_test(stmt.test):
                    # optional-journal idiom: treat the guarded append as
                    # covering the fall-through (journal=None disables
                    # durability wholesale, not the ordering)
                    journaled = journaled or jb
                else:
                    journaled = journaled or ((jb or tb) and (jo or to))
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._check_suite(stmt.body, journaled, module, qual,
                                  findings)
                self._check_suite(stmt.orelse, journaled, module, qual,
                                  findings)
            elif isinstance(stmt, ast.Try):
                jb, tb = self._check_suite(stmt.body, journaled, module,
                                           qual, findings)
                for h in stmt.handlers:
                    self._check_suite(h.body, journaled, module, qual,
                                      findings)
                self._check_suite(stmt.orelse, jb, module, qual, findings)
                jf, _ = self._check_suite(stmt.finalbody, journaled, module,
                                          qual, findings)
                journaled = journaled or jf
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                journaled, term = self._check_suite(stmt.body, journaled,
                                                    module, qual, findings)
                if term:
                    return journaled, True
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue                     # nested defs: separate scope
            else:
                if not journaled:
                    for mnode, desc in _mutations_in_stmt(stmt):
                        findings.append(module.finding(
                            self, mnode,
                            f"{desc} before its journal append — WAL "
                            f"record must dominate the state change",
                            func=qual))
                if _stmt_has_journal(stmt):
                    journaled = True
                if _terminates(stmt):
                    return journaled, True
        return journaled, False
