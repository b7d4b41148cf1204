"""Program counter with retrace-cause classification.

Counterpart of ``repro/engine/cache.py``.  PyTorch runs eagerly, so there
is no compiler to count: a *compile* of a :class:`CountingJit` program is a
call with an input signature (static-arg values, argument structure, and
the shape, dtype and device of every tensor) that the program has not seen
before.  That keeps the reference's metric (programs per run, asserted
O(#size buckets)) and its vocabulary: what would be one trace and compile
under ``jax.jit`` is one new signature here, and the place a later
CUDA-graph capture would key on.

Every new signature after the first is classified against the nearest
earlier one by which component differs: ``static-arg``, ``shape``,
``dtype``, ``device`` (JAX's ``sharding``) or ``tree-structure``.

With ``mesh``, the program runs shard by shard
(:func:`~repro_torch.distributed.sharding.shard_map`) and the counted
call is the whole mesh's, as the reference's ``jit`` wraps its
``shard_map``: one signature holds every shard's leaves, so the count
does not grow with the number of devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import shard_map
from repro_torch.obs.trace import instant as _obs_instant

# cap per-instance event history: retraces are supposed to be rare, and
# a misbehaving caller must not turn the sanitizer into a memory leak
_MAX_EVENTS = 256


def _flatten(obj: Any, leaves: List[Any]) -> str:
    """Append ``obj``'s leaves to ``leaves``; return its structure."""
    if isinstance(obj, torch.Tensor) or obj is None:
        leaves.append(obj)
        return "*"
    if isinstance(obj, (tuple, list)):
        inner = ",".join(_flatten(o, leaves) for o in obj)
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, dict):
        inner = ",".join(f"{k}:{_flatten(obj[k], leaves)}"
                         for k in sorted(obj))
        return f"dict({inner})"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        inner = ",".join(f"{f.name}:{_flatten(getattr(obj, f.name), leaves)}"
                         for f in dataclasses.fields(obj))
        return f"{type(obj).__name__}({inner})"
    leaves.append(obj)
    return "*"


def _leaf_sig(leaf: Any) -> Tuple:
    """(shape, dtype, device) for a tensor; other leaves by type only (a
    Python scalar is data, like a weak-typed trace constant in JAX)."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    return ("py", type(leaf).__name__)


class CountingJit:
    """A counted program: ``fn`` with an exact new-signature counter and
    per-signature cause classification."""

    def __init__(self, fn: Callable, *, static_argnums: Sequence[int] = (),
                 name: Optional[str] = None, mesh=None):
        self._fn = fn if mesh is None else shard_map(fn, mesh)
        self.n_compiles = 0
        self.n_calls = 0
        self.name = name or getattr(fn, "__name__", "program")
        self._static = tuple(static_argnums)
        #: signatures seen, in order of first appearance
        self._seen: List[Tuple] = []
        #: why each new signature appeared (bounded)
        self.retrace_events: List[Dict[str, Any]] = []

    # ------------------------------------------------- cache-key signature
    def _signature(self, args: tuple, kwargs: dict) -> Tuple:
        statics = []
        dynamic = []
        for i, a in enumerate(args):
            if i in self._static:
                statics.append((i, repr(a)))
            else:
                leaves: List[Any] = []
                tree = _flatten(a, leaves)
                dynamic.append((i, tree, tuple(_leaf_sig(x) for x in leaves)))
        for k in sorted(kwargs):
            leaves = []
            tree = _flatten(kwargs[k], leaves)
            dynamic.append((k, tree, tuple(_leaf_sig(x) for x in leaves)))
        return (tuple(statics), tuple(dynamic))

    @staticmethod
    def _diff(sig: Tuple, prev: Tuple) -> List[str]:
        """Which signature components differ between two signatures."""
        kinds = set()
        statics, dynamic = sig
        pstatics, pdynamic = prev
        if statics != pstatics:
            kinds.add("static-arg")
        if len(dynamic) != len(pdynamic):
            kinds.add("tree-structure")
            return sorted(kinds)
        for (pos, tree, leaves), (ppos, ptree, pleaves) in zip(dynamic,
                                                               pdynamic):
            if pos != ppos or tree != ptree or len(leaves) != len(pleaves):
                kinds.add("tree-structure")
                continue
            for leaf, pleaf in zip(leaves, pleaves):
                if leaf == pleaf:
                    continue
                if leaf[0] == "py" or pleaf[0] == "py":
                    kinds.add("tree-structure")
                    continue
                for k, kind in enumerate(("shape", "dtype", "device")):
                    if leaf[k] != pleaf[k]:
                        kinds.add(kind)
        return sorted(kinds)

    def _classify(self, sig: Tuple) -> Tuple[str, str]:
        """(cause, detail) for a new signature: diff against the closest
        earlier one."""
        if not self._seen:
            return "first-trace", ""
        best = min((self._diff(sig, prev) for prev in self._seen), key=len)
        return ("+".join(best) if len(best) > 1 else best[0],
                "differs from nearest earlier trace in: " + ", ".join(best))

    # ------------------------------------------------------------- call
    def __call__(self, *args: Any, **kwargs: Any):
        self.n_calls += 1
        sig = self._signature(args, kwargs)
        if sig not in self._seen:
            self.n_compiles += 1
            cause, detail = self._classify(sig)
            if len(self.retrace_events) < _MAX_EVENTS:
                self.retrace_events.append({
                    "program": self.name, "call": self.n_calls,
                    "compile": self.n_compiles, "cause": cause,
                    "detail": detail})
            _obs_instant("retrace", program=self.name, cause=cause,
                         call=self.n_calls, compile=self.n_compiles)
            self._seen.append(sig)
        return self._fn(*args, **kwargs)

    # ------------------------------------------------------------ stats
    def retrace_summary(self) -> Dict[str, Any]:
        """``{"causes": {cause: count}, "events": [...]}`` for snapshot
        blocks; causes cover every new signature including the first."""
        causes: Dict[str, int] = {}
        for ev in self.retrace_events:
            causes[ev["cause"]] = causes.get(ev["cause"], 0) + 1
        return {"causes": causes, "events": list(self.retrace_events)}


def retrace_report(programs: Dict[str, "CountingJit"]) -> Dict[str, Any]:
    """Merge per-program retrace summaries for an engine snapshot:
    ``{"causes": {...aggregated...}, "by_program": {name: causes}}``."""
    agg: Dict[str, int] = {}
    by_prog: Dict[str, Dict[str, int]] = {}
    for label, cj in programs.items():
        summ = cj.retrace_summary()
        by_prog[label] = summ["causes"]
        for cause, n in summ["causes"].items():
            agg[cause] = agg.get(cause, 0) + n
    return {"causes": agg, "by_program": by_prog}


def merge_retrace_reports(*reports: Dict[str, Any]) -> Dict[str, Any]:
    """Combine :func:`retrace_report` outputs from several planes (e.g.
    the eval engine + the ask engine) into one, summing cause counts.
    Program labels are assumed distinct across planes."""
    agg: Dict[str, int] = {}
    by_prog: Dict[str, Dict[str, int]] = {}
    for rep in reports:
        for cause, n in rep["causes"].items():
            agg[cause] = agg.get(cause, 0) + n
        by_prog.update(rep["by_program"])
    return {"causes": agg, "by_program": by_prog}
