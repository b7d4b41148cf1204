"""A cell's step counted on the meta device: FLOPs, bytes, collectives,
the bytes it holds for the backward, and its working set.

Counterpart of ``repro/launch/hlo_cost.py``, which walks a compiled XLA
HLO module (scaling each loop body by its trip count).  The port has no
HLO; it runs the step itself on meta tensors (shapes only, nothing
allocated or computed) under these counters:

  * flops        — ``torch.utils.flop_counter.FlopCounterMode`` over the
                   forward and the backward (``autograd.grad``): 2·m·n·k
                   a product, as the reference counts a dot.  Remat's
                   recompute runs and is counted, as XLA's HLO holds it.
                   Attention takes its plain version on meta (K6 and K7
                   launch nothing there), so its products are the plain
                   path's full S² ones, the parity yardstick;
                   :func:`attention_costs` gives the kernels' own.
  * bytes        — Σ (result + operand bytes) of every aten op that
                   moves data (views move none), the HBM-traffic proxy of
                   the reference's.  What the flash wrappers' plain
                   versions move (their S² scores, masks and
                   probabilities, which K6 and K7 never write) is also
                   kept apart, so that the kernels' own bytes can take
                   its place.
  * collectives  — an empty dict: one card (ROADMAP queue A item 9b).
  * saved_bytes  — the bytes held for the backward when the forward ends
                   (``saved_tensors_hooks``, each storage once, the
                   parameters' own storages left out, plus what the
                   "dots" policy keeps in the checkpoint's cache, which
                   no hook sees).  That is what remat changes.
  * work_bytes   — the peak of the bytes alive at once in the storages
                   the step's ops create (activations, what is saved,
                   gradients, the update's temporaries), each followed
                   until it is freed.  A flash call adds its outputs
                   alone, as K6 and K7 allocate no S² buffer.  The step's
                   arguments (parameters, optimizer state, cache, batch)
                   are not in it.

The flash wrappers and the "dots" policy are wrapped while a count runs
(:meth:`Counts.run`), so that their calls are seen; the model and the
kernels hold nothing of the counter.

A train cell counts one microbatch (``compute_grads`` on its rows and,
with microbatches, the accumulation) and multiplies it by
``grad_accum``, as the reference multiplies a loop body by its trip
count; the accumulator and the AdamW update count once.  Every
microbatch makes the same allocations, so the peak is one microbatch's.
Prefill and decode cells run without grad mode.

The hybrid and ssm families' scans loop in Python over time
(``rglru._rg_lru``, ``xlstm.slstm_scan``): on meta a 4,096-step train row
of recurrentgemma-9b took 321 s, and prefill_32k would take eight times
as long.  Every count of their train and prefill steps but the peak is a
polynomial of degree two in the sequence length S (the products and
elementwise work scale with S, the scans with S steps, attention's plain
products and masks with S²) once S holds two units (a unit: the mLSTM
chunk, or 16; one chunk alone carries no state to a next one, so its
backward differs).  Such a cell is counted at S = 2, 3 and 4 units and
the quadratic through the three is read at the cell's S, as the
reference scales a loop body by its trip count.  Its flash calls are the
first run's, at the cell's S (these families' attention is
self-attention: Sq = Sk = S).  A peak is no polynomial (the point of the
step that sets it can move with S), so such a cell's ``work_bytes`` is
None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from fractions import Fraction
from typing import Any, Dict, List, Optional
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash import kernel as FK
from repro_torch.kernels.flash.cost import bwd_cost, fwd_cost
from repro_torch.launch.shapes import (ShapeCell, build_cell,
                                       default_grad_accum)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import OptimConfig, apply_updates, tree_leaves
from repro_torch.train.step import accumulate, accumulator, compute_grads

# ops that allocate or alias and move no data
_A = torch.ops.aten
_FREE = {_A._unsafe_view.default, _A.empty.memory_format,
         _A.empty_like.default, _A.empty_strided.default,
         _A.new_empty.default, _A.lift_fresh.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Live:
    """The storages that ops create, and the peak of their bytes alive at
    once: each is added when an op returns it for the first time (not
    one of the op's inputs: an in-place op or a view makes none) and
    taken away when it is freed."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._keys = set()

    def add(self, out, inputs) -> None:
        seen = {t.untyped_storage()._cdata for t in _tensors(inputs)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._keys:
                continue
            self._keys.add(key)
            self.now += st.nbytes()
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._free, key, st.nbytes())

    def _free(self, key, nbytes: int) -> None:
        self._keys.discard(key)
        self.now -= nbytes


class _Tally(TorchDispatchMode):
    """Σ (result + operand bytes) of every op that moves data, and apart
    the part moved inside a flash wrapper's plain version; the storages
    ops create, outside a flash wrapper, go to ``live``."""

    def __init__(self, live: _Live):
        super().__init__()
        self.bytes = 0
        self.attention_bytes = 0
        self.in_flash = 0
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _FREE:
            n = _nbytes((args, kwargs)) + _nbytes(out)
            self.bytes += n
            if self.in_flash:
                self.attention_bytes += n
        if not self.in_flash:
            self.live.add(out, (args, kwargs))
        return out


class Counts:
    """Running totals of one counted region: ``flops``, ``bytes`` (of
    which ``attention_bytes`` inside flash calls), ``saved_bytes``, the
    flash calls it made (``attention``) and the working set (``live``,
    shared with ``live``'s other counts)."""

    def __init__(self, params=None, live: Optional[_Live] = None):
        self.flops = 0
        self.bytes = 0
        self.attention_bytes = 0
        self.saved_bytes = 0
        self.attention: List[tuple] = []
        self.live = live or _Live()
        self._own = {p.untyped_storage()._cdata
                     for p in tree_leaves(params or {})}

    @contextlib.contextmanager
    def run(self, saving: bool = False):
        """Count what runs inside; with ``saving``, also the bytes saved
        for a backward (each storage once)."""
        flops, tally = FlopCounterMode(display=False), _Tally(self.live)
        held: Dict[int, int] = {}
        kept: List[int] = []

        def pack(t):
            # a saved storage lives until the backward, so no other takes
            # its key while the forward saves; a detached alias, as a
            # saved output returned as itself would hold its own graph
            # node and outlive the backward
            st = t.untyped_storage()
            if st._cdata not in self._own:
                held[st._cdata] = st.nbytes()
            return t.detach()

        def flash(direction, fn):
            def counted(q, k, *args, causal=True, window=None, **kw):
                b, sq, nh, hd = q.shape
                self.attention.append((direction, q.dtype, b, sq, k.shape[1],
                                       nh, k.shape[2], hd, causal, window))
                tally.in_flash += 1
                try:
                    out = fn(q, k, *args, causal=causal, window=window, **kw)
                finally:
                    tally.in_flash -= 1
                self.live.add(out, (q, k, args, kw))
                return out
            return counted

        keep_dots = lm._keep_dots

        def keep(ctx, op, *args, **kwargs):
            policy = keep_dots(ctx, op, *args, **kwargs)
            if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                a, b = args[-2], args[-1]
                kept.append(a.shape[0] * b.shape[1] * a.element_size())
            return policy

        hooks = (torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)
                 if saving else contextlib.nullcontext())
        try:
            with mock.patch.object(FK, "flash_attention_fwd",
                                   flash("fwd", FK.flash_attention_fwd)), \
                    mock.patch.object(FK, "flash_attention_bwd",
                                      flash("bwd", FK.flash_attention_bwd)), \
                    mock.patch.object(lm, "_keep_dots", keep), \
                    flops, tally, hooks:
                yield self
        finally:
            self.flops += flops.get_total_flops()
            self.bytes += tally.bytes
            self.attention_bytes += tally.attention_bytes
            if saving:
                self.saved_bytes += sum(held.values()) + sum(kept)

    def scaled(self, n: int) -> "Counts":
        out = Counts(live=self.live)
        out.flops, out.bytes = n * self.flops, n * self.bytes
        out.attention_bytes = n * self.attention_bytes
        out.saved_bytes = self.saved_bytes
        out.attention = self.attention * n
        return out


def attention_costs(calls) -> Dict[str, float]:
    """The flash calls of a count: the FLOPs their plain versions did
    (2·B·NH·Sq·Sk·hd a product: two forward, five backward) and the
    operations and bytes K6 and K7 need (closed-form visible pairs,
    queries suffix-aligned: a self-attention over the sequence, a decode
    step over a full cache), and the calls of each."""
    out = dict(plain_flops=0, kernel_flops=0, kernel_bytes=0, k6_calls=0,
               k7_calls=0)
    for direction, dtype, b, sq, sk, nh, kh, hd, causal, window in calls:
        fwd = direction == "fwd"
        out["plain_flops"] += (4 if fwd else 10) * b * nh * sq * sk * hd
        nbytes, ops, _ = (fwd_cost if fwd else bwd_cost)(
            dtype, b, sq, sk, nh, kh, hd, causal, window)
        out["kernel_flops"] += ops
        out["kernel_bytes"] += nbytes
        out["k6_calls" if fwd else "k7_calls"] += 1
    return out


def count_train(cfg: ModelConfig, params, opt_state, batch,
                opt_cfg: OptimConfig, grad_accum: int) -> Counts:
    """A train step's counts: one microbatch's ``compute_grads`` (and
    accumulation) × ``grad_accum``, plus the accumulator and the AdamW
    update once."""
    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{grad_accum} microbatches")
    mb = rows // grad_accum
    micro = {k: v[:mb] for k, v in batch.items()}
    comp = opt_cfg.grad_compression
    per = Counts(params)
    once = Counts(params, per.live)
    acc = None
    if grad_accum > 1:
        with once.run():
            acc = accumulator(params, comp)
    with per.run(saving=True):
        _, grads = compute_grads(params, cfg, micro, compression=comp)
    if acc is not None:
        with per.run():
            accumulate(acc, grads, grad_accum)
        grads = acc
    with once.run():
        apply_updates(params, grads, opt_state, opt_cfg)
    total = per.scaled(grad_accum)
    total.flops += once.flops
    total.bytes += once.bytes
    total.attention_bytes += once.attention_bytes
    total.attention += once.attention
    return total


def scan_unit(cfg: ModelConfig) -> int:
    """The sequence unit of a family whose scans loop over time (0 for
    the others): the mLSTM chunk (S must be a multiple of it), or 16."""
    return {"ssm": cfg.mlstm_chunk, "hybrid": 16}.get(cfg.family, 0)


COUNT_UNITS = (2, 3, 4)
# the counts read off the quadratic
POLYNOMIAL = ("flops", "bytes", "attention_bytes", "saved_bytes")


def _quadratic_at(ys, unit: int, s: int) -> int:
    """The quadratic through (k·unit, ys[i]) for k in COUNT_UNITS, read
    at s (Lagrange, in exact fractions)."""
    x, val = Fraction(s, unit), Fraction(0)
    for i, k in enumerate(COUNT_UNITS):
        term = Fraction(ys[i])
        for j in COUNT_UNITS:
            if j != k:
                term *= (x - j) / (k - j)
        val += term
    return round(val)


def _count(cfg, shape, opt_cfg, grad_accum, built) -> Counts:
    step, args = built or build_cell(cfg, shape, opt_cfg=opt_cfg,
                                     grad_accum=grad_accum)
    if shape.kind == "train":
        return count_train(cfg, *args, opt_cfg=opt_cfg,
                           grad_accum=grad_accum)
    c = Counts(args[0])
    with torch.no_grad(), c.run():
        step(*args)
    return c


def summary(c: Counts, work: Optional[int]) -> Dict[str, Any]:
    """The counts of a :class:`Counts` as :func:`count_cell` gives them
    (``work_bytes``: ``work``)."""
    att = attention_costs(c.attention)
    att["plain_bytes"] = c.attention_bytes
    return {"flops": c.flops, "bytes": c.bytes, "collectives": {},
            "saved_bytes": c.saved_bytes, "work_bytes": work,
            "attention": att}


def count_cell(cfg: ModelConfig, shape: ShapeCell, *,
               opt_cfg: Optional[OptimConfig] = None,
               grad_accum: Optional[int] = None, built=None
               ) -> Dict[str, Any]:
    """→ {"flops", "bytes", "collectives", "saved_bytes", "work_bytes",
    "attention", "grad_accum", "counted_at"} of one cell's step:
    ``built`` (``build_cell``'s (step, args) on meta, with the same
    options), or built here.  A hybrid or ssm train or prefill cell
    longer than four units is counted at 2, 3 and 4 units and read off
    the quadratic through them, its ``work_bytes`` None; ``counted_at``
    lists the sequence lengths that ran."""
    opt_cfg = opt_cfg or OptimConfig()
    if shape.kind == "train" and grad_accum is None:
        grad_accum = default_grad_accum(shape)
    unit, s = scan_unit(cfg), shape.seq_len
    if unit and shape.kind != "decode" and s > COUNT_UNITS[-1] * unit:
        first = COUNT_UNITS[0] * unit
        runs = [_count(cfg, dataclasses.replace(shape, seq_len=k * unit),
                       opt_cfg, grad_accum, None) for k in COUNT_UNITS]
        c = Counts()
        for key in POLYNOMIAL:
            setattr(c, key, _quadratic_at([getattr(r, key) for r in runs],
                                          unit, s))
        for call in runs[0].attention:
            if call[3] != first or call[4] != first:
                raise ValueError(f"{cfg.name}: a flash call at Sq, Sk = "
                                 f"{call[3:5]} is not a self-attention "
                                 f"over the sequence")
            c.attention.append(call[:3] + (s, s) + call[5:])
        out = summary(c, None)
        counted_at = [k * unit for k in COUNT_UNITS]
    else:
        c = _count(cfg, shape, opt_cfg, grad_accum, built)
        out = summary(c, c.live.peak)
        counted_at = [s]
    out.update(grad_accum=grad_accum if shape.kind == "train" else 1,
               counted_at=counted_at)
    return out
