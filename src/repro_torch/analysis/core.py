"""Core of the invariant lint engine: findings, rules, project model.

Counterpart of ``repro/analysis/core.py``.  The linter enforces the
ROADMAP contracts *statically*: every rule is a pure function over parsed
ASTs, so a violating call site is caught at review time even when no
runtime test exercises it.  The model is deliberately small:

* :class:`Finding` — one violation (rule id, file:line, severity,
  message, enclosing function, source snippet).
* :class:`Rule` — a named check run once per module with the whole
  :class:`Project` available for cross-module facts.
* :class:`ModuleInfo` — one parsed file plus its inline suppressions.
* :class:`Project` — all modules and a bare-name function table, with
  the name resolution the recompile-hazard rule follows from a
  ``CountingJit(fn)`` to ``fn``'s body.

The reference also computes a *traced closure* (every function reachable
from a ``jit``/``vmap``/``while_loop`` root) for its host-leak and NaN
rules; the port traces nothing, runs neither rule, and keeps none of it.

Name resolution is heuristic by design (bare last-segment matching,
same-module candidates preferred).  False positives are expected to be
*triaged*, not silenced: either fix the code, or suppress with a reason
(inline ``# repro: allow[rule-id] reason`` or a baseline entry — both
reject empty reasons).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"

# inline suppression: ``# repro: allow[rule-id] reason text``
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([a-z0-9-]+)\]\s*(.*)$")


@dataclasses.dataclass
class Finding:
    rule: str
    file: str                 # repo-relative path
    line: int
    severity: str
    message: str
    func: str = ""            # enclosing function qualname ("" = module)
    snippet: str = ""         # stripped source line (baseline matching)

    def key(self) -> Tuple[str, str, str, str]:
        """Line-number-free identity used for baseline matching."""
        return (self.rule, self.file, self.func, self.snippet)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        where = f" (in {self.func})" if self.func else ""
        return (f"{self.file}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}{where}")


class Rule:
    """Base class: subclasses set ``id``/``severity`` and implement
    :meth:`run`."""
    id: str = ""
    severity: str = SEV_ERROR
    doc: str = ""

    def run(self, module: "ModuleInfo", project: "Project") -> List[Finding]:
        raise NotImplementedError


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(node: ast.AST) -> Optional[str]:
    """Final attribute/name of a call target: ``self.x.append`` → append."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def call_target(call: ast.Call) -> Optional[str]:
    return last_segment(call.func)


class _Parented(ast.NodeVisitor):
    """Annotate every node with ``._parent`` (rules walk upward for
    context, e.g. "is this attribute the tail of a longer chain?")."""

    def generic_visit(self, node):
        for child in ast.iter_child_nodes(node):
            child._parent = node          # type: ignore[attr-defined]
        super().generic_visit(node)


def parent_of(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_parent", None)


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = parent_of(node)
    while cur is not None:
        yield cur
        cur = parent_of(cur)


# --------------------------------------------------------------------------
# module / project model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    name: str                       # bare name ("" for lambdas)
    qualname: str                   # Class.method / outer.inner
    module: "ModuleInfo"
    node: ast.AST                   # FunctionDef | AsyncFunctionDef | Lambda


class ModuleInfo:
    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        _Parented().visit(self.tree)
        # line → (rule-id, reason) inline suppressions
        self.allows: Dict[int, Tuple[str, str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(text)
            if m:
                self.allows[i] = (m.group(1), m.group(2).strip())

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: Rule, node: ast.AST, message: str,
                func: str = "", severity: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule.id, file=self.rel, line=line,
                       severity=severity or rule.severity, message=message,
                       func=func, snippet=self.line_text(line))

    def allow_for(self, finding: Finding) -> Optional[Tuple[str, str]]:
        """Inline allow covering this finding (same or previous line)."""
        for ln in (finding.line, finding.line - 1):
            ent = self.allows.get(ln)
            if ent and ent[0] == finding.rule:
                return ent
        return None


class Project:
    """All parsed modules plus a bare-name function table."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        # bare function name → candidates (module-order stable)
        self.functions: Dict[str, List[FuncInfo]] = {}
        self._func_by_node: Dict[int, FuncInfo] = {}
        for mod in self.modules:
            self._index_functions(mod)

    def _index_functions(self, mod: ModuleInfo) -> None:
        def visit(node: ast.AST, qual: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{qual}.{child.name}" if qual else child.name
                    fi = FuncInfo(name=child.name, qualname=q, module=mod,
                                  node=child)
                    self.functions.setdefault(child.name, []).append(fi)
                    self._func_by_node[id(child)] = fi
                    visit(child, q)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{qual}.{child.name}" if qual
                          else child.name)
                else:
                    visit(child, qual)
        visit(mod.tree, "")

    def func_for_node(self, node: ast.AST) -> Optional[FuncInfo]:
        return self._func_by_node.get(id(node))

    def enclosing_function(self, node: ast.AST) -> str:
        for anc in ancestors(node):
            fi = self._func_by_node.get(id(anc))
            if fi is not None:
                return fi.qualname
        return ""

    def resolve(self, expr: ast.AST, mod: ModuleInfo,
                encl: Optional[ast.AST] = None,
                depth: int = 0) -> List[FuncInfo]:
        """Resolve a function-valued expression to candidate defs.

        Resolution is deliberately conservative — over-resolving a
        common name (``step``, ``append``) would drag unrelated host code
        into a rule's scope:

        * bare names: the *enclosing function's* locals first (nested
          defs, ``f = partial(g, ...)``-style rebindings), then
          module-level defs, then a global match only when the name is
          unique project-wide;
        * ``self.X``: same-module definitions only;
        * other dotted attributes: same module, else unique-global;
        * ``functools.partial(f, ...)`` unwraps to ``f``; inline lambdas
          resolve to themselves.
        """
        if depth > 4:
            return []
        if isinstance(expr, ast.Lambda):
            fi = self._func_by_node.get(id(expr))
            if fi is None:
                fi = FuncInfo(name="", qualname="<lambda>", module=mod,
                              node=expr)
                self._func_by_node[id(expr)] = fi
            return [fi]
        if isinstance(expr, ast.Call) and call_target(expr) == "partial":
            return self.resolve(expr.args[0], mod, encl, depth + 1) \
                if expr.args else []
        if isinstance(expr, ast.Name):
            if encl is not None:
                hit = self._resolve_local(expr.id, encl, mod, depth)
                if hit is not None:
                    return hit
            cands = self.functions.get(expr.id, [])
            local = [c for c in cands if c.module is mod]
            if local:
                return local
            return cands if len(cands) == 1 else []
        if isinstance(expr, ast.Attribute):
            chain = dotted_name(expr)
            cands = self.functions.get(expr.attr, [])
            local = [c for c in cands if c.module is mod]
            if chain is not None and chain.startswith(("self.", "cls.")) \
                    and chain.count(".") == 1:
                return local
            if local:
                return local
            return cands if len(cands) == 1 else []
        return []

    def _resolve_local(self, name: str, encl: ast.AST, mod: ModuleInfo,
                       depth: int) -> Optional[List[FuncInfo]]:
        """Locals of ``encl`` shadow the tables: a nested def wins, and a
        ``name = <expr>`` assignment resolves through its value.  Returns
        None when ``name`` is not bound locally."""
        for node in ast.walk(encl):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not encl and node.name == name:
                fi = self._func_by_node.get(id(node))
                return [fi] if fi else []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return self.resolve(node.value, mod, encl,
                                            depth + 1)
        # a parameter of the enclosing function: opaque, don't guess
        args = getattr(encl, "args", None)
        if args is not None:
            params = {p.arg for p in args.posonlyargs + args.args
                      + args.kwonlyargs}
            if name in params:
                return []
        return None


def load_project(paths: Sequence[Path], root: Path,
                 exclude: Sequence[str] = ("tests",)) -> Project:
    files: List[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
    mods = []
    for f in files:
        rel = str(f.resolve().relative_to(root.resolve())) \
            if f.resolve().is_relative_to(root.resolve()) else str(f)
        if any(part in exclude for part in Path(rel).parts):
            continue
        try:
            src = f.read_text()
            mods.append(ModuleInfo(f, rel, src))
        except (SyntaxError, UnicodeDecodeError):
            continue
    return Project(mods)
