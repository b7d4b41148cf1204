"""Runtime sanitizer: the opt-in NaN guard (counterpart of
``repro/analysis/runtime.py``).

The fleet keeps idle and quarantined slots finite (the ``_FAR`` benign-row
pattern); this guard proves it at runtime: every float tensor entering or
leaving a guarded program is finite, idle and quarantined rows included.
It costs one host sync per program call (per device the call's tensors
live on), so it is strictly opt-in (chaos runs, debugging), never the hot
path.

Guarded planes: the three fleet block programs (full refit, incremental
refit, MSO tail) and the two solo AskEngine programs (fused full /
incremental ask); :func:`install_nan_guard` picks the set from the
engine's attributes.  A tripped guard reports through the obs plane (a
``nan_guard.nonfinite`` instant on the flight-recorder timeline) before
raising, so a crashed chaos run shows *where* the poison crossed a
program boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, List, Tuple

import torch

from repro_torch.obs.trace import instant as _obs_instant


class NonFiniteError(AssertionError):
    """A float tensor crossing a guarded program boundary was NaN/Inf."""


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every floating tensor leaf, in order.  Paths read
    like ``jax.tree_util.keystr``: ``[i]`` for a tuple or list entry,
    ``['k']`` for a dict key, ``.name`` for a NamedTuple or dataclass
    field."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")


def _first_nonfinite(tree: Any) -> Tuple[str, Any]:
    """(path, leaf) of the first non-finite float leaf, or ("", None).
    One host sync per device: every leaf's ``isfinite().all()`` is stacked
    and read at once; only a failing tree is walked again, to name the
    leaf."""
    leaves: List[Tuple[str, torch.Tensor]] = list(_leaves(tree))
    by_dev = {}
    for _, leaf in leaves:
        by_dev.setdefault(leaf.device, []).append(
            torch.isfinite(leaf).all())
    if all(bool(torch.stack(flags).all()) for flags in by_dev.values()):
        return "", None
    for path, leaf in leaves:
        if not bool(torch.isfinite(leaf).all()):
            return path, leaf
    return "", None


class FiniteGuard:
    """Wrap a CountingJit-like callable with finite-checks on every
    float input and output tensor.  All other attributes (``n_compiles``,
    ``retrace_summary`` …) pass through, so engine snapshots keep
    working on the guarded program."""

    def __init__(self, inner, label: str):
        self._inner = inner
        self._label = label
        self.n_guard_checks = 0

    def _check(self, tree: Any, direction: str) -> None:
        path, leaf = _first_nonfinite(tree)
        if leaf is not None:
            _obs_instant("nan_guard.nonfinite", program=self._label,
                         direction=direction, leaf=path or "<root>")
            raise NonFiniteError(
                f"non-finite value in {direction} of guarded program "
                f"'{self._label}' at leaf {path or '<root>'} "
                f"(shape {tuple(leaf.shape)}): the _FAR benign-row "
                f"invariant is violated — an idle/quarantined slot leaked "
                f"NaN/Inf into the shared carry")

    def __call__(self, *args: Any, **kwargs: Any):
        self.n_guard_checks += 1
        self._check((args, kwargs), "inputs")
        out = self._inner(*args, **kwargs)
        self._check(out, "outputs")
        return out

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


_FLEET_PROGRAMS = ("_full_prog", "_incr_prog", "_mso_prog")
_ASK_PROGRAMS = ("_full_prog", "_incr_prog")


def _program_attrs(engine) -> Tuple[str, ...]:
    """Which program attributes an engine exposes: the fleet plane carries
    a separate MSO tail program, the solo AskEngine fuses it into its
    two programs."""
    return _FLEET_PROGRAMS if hasattr(engine, "_mso_prog") \
        else _ASK_PROGRAMS


def install_nan_guard(engine) -> Iterable[FiniteGuard]:
    """Wrap an engine's programs in place, outermost (over their
    ``ProgramTimer``): the three fleet block programs or the two solo
    AskEngine programs.  Returns the guards (idempotent: re-installing
    over an existing guard is a no-op)."""
    guards = []
    for attr in _program_attrs(engine):
        prog = getattr(engine, attr)
        if isinstance(prog, FiniteGuard):
            guards.append(prog)
            continue
        g = FiniteGuard(prog, attr.strip("_").replace("_prog", ""))
        setattr(engine, attr, g)
        guards.append(g)
    return guards


def nan_guard_stats(engine) -> dict:
    """``{"installed": bool, "n_guard_checks": int}`` for summaries."""
    progs = [getattr(engine, a, None) for a in _program_attrs(engine)]
    installed = all(isinstance(p, FiniteGuard) for p in progs)
    return {"installed": installed,
            "n_guard_checks": sum(p.n_guard_checks for p in progs
                                  if isinstance(p, FiniteGuard))}
