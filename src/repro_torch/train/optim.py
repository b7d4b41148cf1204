"""AdamW (no optimizer library) with ZeRO-1 state sharding on a mesh and
the reference's gradient-compression options.

Counterpart of ``repro/train/optim.py``.  The update keeps
the reference's formula and casts: ``g·clip`` in float32, bias-corrected
float32 moments, ``delta = m̂/(√n̂ + eps) + wd·p`` and ``new_p = (p.f32 −
lr·delta).to(p.dtype)``, with no float32 master weights.  It runs in
place under ``torch.no_grad()``, one leaf at a time: the parameters and
moments are overwritten, and no float32 copy of the whole gradient tree
is made (a bfloat16 gradient leaf is cast to float32 when its turn
comes; the reference casts the whole tree first, which gives the same
values).

``grad_compression``:
  - ``"bf16"``: gradients are rounded to bfloat16 (``train/step.py``);
    with microbatches the accumulator is bfloat16 too;
  - ``"int8_ef"``: per-leaf int8 quantization with error-feedback
    residuals ``ef`` carried in the state (float32, one per leaf).

``lr_schedule`` and the bias corrections are float32, as in the
reference (whose schedule stays float32 under x64 too), computed on the
host from a host step counter, so a step reads no device value.

On a ("data", "model") mesh (the ambient one, ``launch/mesh.py::
use_mesh``; ``axes`` gives the parameters' logical axes, resolved for the
mesh as ``lm.param_axes`` gives them there, so that a local shard's
global shape is exact: the dense and hybrid trees, hd- and "lru"-split
leaves included) the state is
ZeRO-1: each moment (and error-feedback residual) holds only this rank's
"data" slice of its parameter's local shard, on the first dim that is
not sharded and that "data" divides (:func:`zero1_pspec`; a leaf with no
such dim keeps it whole on every rank).  ``apply_updates`` takes the
gradients reduced over "data" (whole, or already the ZeRO slice:
:func:`constrain_grads_zero1`, ZeRO-2), updates that slice of each
parameter in the sharded domain, then all-gathers the new parameters
over "data" in their own dtype; its ``grad_norm`` sums the squares of
the distinct pieces over the mesh, a piece that ranks replicate counted
once, and ``"int8_ef"`` scales each leaf by its whole max, as the
reference's.  Off a mesh nothing of this runs.  ``zero1`` is kept in
:class:`OptimConfig` so a config reads the same in both packages; as in
the reference, the mesh decides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (NamedSharding,
                                              get_abstract_mesh,
                                              global_shape, pspec, zip_map)

Tensor = torch.Tensor


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    zero1: bool = True
    shard_grads: bool = True           # ZeRO-2-style grad sharding (mesh)
    grad_compression: str = "none"     # none | bf16 | int8_ef


class AdamState(NamedTuple):
    step: Tensor    # () int32 on the host
    mu: Any         # first moment (param tree, float32)
    nu: Any         # second moment
    ef: Any         # error-feedback residuals (or empty tuple)


# ---------------------------------------------------------------- trees
def tree_leaves(tree) -> List[Tensor]:
    """Leaves of nested dicts / lists / tuples in the reference's order
    (``jax.tree.leaves``: dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ----------------------------------------------------------- ZeRO layout
@dataclass(frozen=True)
class LeafLayout:
    """Where a leaf's ZeRO slice lives on a mesh: its partition spec (the
    parameter's with "data" added) and the dim "data" splits (None: the
    leaf is kept whole)."""
    zspec: tuple
    zdim: Any


def zero_layout(tree, axes, mesh):
    """:class:`LeafLayout` of every local leaf of ``tree`` (logical
    ``axes``, same structure) on ``mesh``."""
    names, sizes = mesh.axis_names, mesh.sizes

    def one(x, ax):
        glob = global_shape(x.shape, ax, mesh)
        spec = pspec(glob, ax, names, sizes)
        zspec = zero1_pspec(spec, glob, names, sizes)
        zdim = next((i for i, (a, b) in enumerate(zip(zspec, spec))
                     if a != b), None)
        return LeafLayout(zspec, zdim)
    return zip_map(one, tree, axes)


def zero_sharding(shape, axes, mesh):
    """The ZeRO :class:`~repro_torch.distributed.sharding.NamedSharding`
    of a leaf of global ``shape`` and logical ``axes`` on ``mesh``: its
    parameter's spec with "data" added (:func:`zero1_pspec`)."""
    spec = pspec(shape, axes, mesh.axis_names, mesh.sizes)
    return NamedSharding(mesh, zero1_pspec(spec, shape, mesh.axis_names,
                                           mesh.sizes))


def _zslice(x: Tensor, lay: LeafLayout, mesh) -> Tensor:
    """This rank's ZeRO slice of a leaf's local shard (a view)."""
    if lay.zdim is None:
        return x
    n = x.shape[lay.zdim] // mesh.axis_size("data")
    return x.narrow(lay.zdim, mesh.coords["data"] * n, n)


def _mesh(axes):
    """The ambient mesh when ``axes`` are needed and given."""
    mesh = get_abstract_mesh()
    if mesh is not None and axes is None:
        raise ValueError("on a mesh the optimizer needs the parameters' "
                         "logical axes (axes=lm.param_axes(cfg))")
    return mesh


# ---------------------------------------------------------------- state
def init_opt_state(params, cfg: OptimConfig, axes=None) -> AdamState:
    """Zero moments (and residuals), float32; on a mesh each this rank's
    ZeRO slice of its parameter's shard."""
    mesh = _mesh(axes)
    if mesh is not None:
        def zslice(p, lay):
            return torch.zeros_like(_zslice(p, lay, mesh),
                                    dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
        lay = zero_layout(params, axes, mesh)
        ef = (zip_map(zslice, params, lay)
              if cfg.grad_compression == "int8_ef" else ())
        return AdamState(step=torch.zeros((), dtype=torch.int32),
                         mu=zip_map(zslice, params, lay),
                         nu=zip_map(zslice, params, lay), ef=ef)

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    ef = tree_map(zeros, params) if cfg.grad_compression == "int8_ef" else ()
    return AdamState(step=torch.zeros((), dtype=torch.int32),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     ef=ef)


def lr_schedule(cfg: OptimConfig, step) -> float:
    """Linear warmup, then cosine decay to 0.1·lr: the reference's float32
    arithmetic, in its order, on the host (a Python float holding the
    float32 value)."""
    f = np.float32
    step = f(int(step))
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = min(max((step - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0.0)),
               f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * warm * (f(0.1) + f(0.9) * cos))


def _int8_ef(g: Tensor, ef: Tensor, amax=None
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """(int8 q, its scale, the new residual) of g + ef; ``amax`` turns
    this slice's max|g + ef| into the whole leaf's (on a mesh)."""
    gc = g.float() + ef
    peak = gc.abs().max()
    peak = peak if amax is None else amax(peak)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    return q, scale, gc - q.float() * scale


def _quantize_int8_ef(g: Tensor, ef: Tensor) -> Tuple[Tensor, Tensor]:
    """Error-feedback int8 round trip: (decompressed, new residual)."""
    q, scale, res = _int8_ef(g, ef)
    return q.float() * scale, res


def _norm(leaves) -> Tensor:
    total = None
    for x in leaves:
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _owned(lay: LeafLayout, mesh) -> bool:
    """Whether this rank counts its piece of a leaf: the one at
    coordinate 0 of every mesh axis the piece is replicated over."""
    split = {e for entry in lay.zspec if entry
             for e in ((entry,) if isinstance(entry, str) else entry)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


def _mesh_norm(pieces, lays, mesh) -> Tensor:
    """sqrt(Σ x²) over the distinct pieces of the leaves on the mesh: each
    rank sums the pieces it owns, the sums are added over every axis."""
    total = None
    for x, lay in zip(pieces, lays):
        if _owned(lay, mesh):
            s = x.float().square().sum()
            total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for a in mesh.axis_names:
        total = C.all_reduce(total, a, mesh=mesh)
    return torch.sqrt(total)


def global_norm(tree) -> Tensor:
    """sqrt(Σ over leaves, in the reference's order, of Σ x²), float32
    (on a mesh ``apply_updates`` sums its ZeRO slices: ``_mesh_norm``)."""
    return _norm(tree_leaves(tree))


def apply_updates(params, grads, state: AdamState, cfg: OptimConfig,
                  axes=None) -> Tuple[Any, AdamState, Dict[str, Any]]:
    """One AdamW step, in place: ``params``' leaves and the state's
    moments (and ``ef``) are overwritten, and returned.  ``grads`` has
    ``params``' structure, in any float dtype.  Metrics: ``grad_norm`` (a
    0-dim float32 tensor on the gradients' device) and ``lr`` (a float).

    On a mesh (``axes``: the parameters' logical axes) each gradient leaf
    is reduced over "data" already, whole or as its ZeRO slice; the
    update runs on the ZeRO slice of each parameter, then the slices are
    all-gathered over "data"."""
    step = state.step + 1
    lr = lr_schedule(cfg, int(step))
    mesh = _mesh(axes)
    with torch.no_grad():
        g_leaves = tree_leaves(grads)
        p_leaves = tree_leaves(params)
        lays = amax = None
        if mesh is not None:
            lays = tree_leaves(zero_layout(params, axes, mesh))
            g_leaves = [_zslice(g, lay, mesh) if g.shape == p.shape else g
                        for g, p, lay in zip(g_leaves, p_leaves, lays)]
        if cfg.grad_compression == "int8_ef":
            # each leaf kept as int8 and its scale, the residual written
            # in place; the norm and the update dequantize it (same bits)
            packed = []
            for i, (g, e) in enumerate(zip(g_leaves,
                                           tree_leaves(state.ef))):
                if mesh is not None:
                    amax = _leaf_max(lays[i], mesh)
                q, scale, res = _int8_ef(g, e, amax)
                e.copy_(res)
                packed.append((q, scale))

            def grad(i):
                return packed[i][0].float() * packed[i][1]
        else:
            def grad(i):
                return g_leaves[i]
        n = len(g_leaves)
        gnorm = (_norm(grad(i) for i in range(n)) if mesh is None else
                 _mesh_norm([grad(i) for i in range(n)], lays, mesh))
        clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if cfg.grad_clip > 0 else None)
        t = np.float32(int(step))
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
        for i, (p, mu, nu) in enumerate(zip(p_leaves,
                                            tree_leaves(state.mu),
                                            tree_leaves(state.nu))):
            g32 = grad(i).float()
            if clip is not None:
                g32 = g32 * clip
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            del g32
            delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            pz = p if mesh is None else _zslice(p, lays[i], mesh)
            delta.add_(cfg.weight_decay * pz.float())
            pz.copy_(pz.float().sub_(lr * delta))
            del delta
            if mesh is not None and lays[i].zdim is not None:
                p.copy_(C.all_gather(pz, "data", dim=lays[i].zdim,
                                     mesh=mesh))
    new_state = AdamState(step=step, mu=state.mu, nu=state.nu, ef=state.ef)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _leaf_max(lay: LeafLayout, mesh):
    """The max of a 0-dim tensor over the mesh axes a leaf's ZeRO slices
    split over (the whole leaf's max from every rank's slice)."""
    split = [e for entry in lay.zspec if entry
             for e in ((entry,) if isinstance(entry, str) else entry)]

    def amax(x):
        for a in split:
            x = C.all_reduce(x, a, op="max", mesh=mesh)
        return x
    return amax


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state's extra "data" sharding
# ---------------------------------------------------------------------------

def zero1_pspec(param_spec, shape, mesh_axis_names, mesh_shape) -> tuple:
    """The reference's ZeRO-1 rule on plain tuples: extend a parameter's
    partition spec with "data" on the first dim that is unsharded and
    divisible by the data axis; unchanged without a "data" axis or when
    the spec already uses it."""
    if "data" not in mesh_axis_names:
        return tuple(param_spec)

    def _axes(entry):
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    if any("data" in _axes(e) for e in param_spec):
        return tuple(param_spec)
    dsize = mesh_shape.get("data", 1)
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (s, cur) in enumerate(zip(shape, spec)):
        if cur is None and dsize > 1 and s % dsize == 0:
            spec[i] = "data"
            break
    return tuple(spec)


def constrain_grads_zero1(grads, mesh=None, axes=None):
    """The data-parallel gradient reduction into the ZeRO layout (the
    reference constrains the gradients to the ZeRO specs, and GSPMD then
    reduce-scatters them): each leaf's local gradient summed over "data"
    by ``reduce_scatter`` into this rank's ZeRO slice, or by
    ``all_reduce`` where the leaf has no ZeRO dim, and then summed over
    "pod" if the mesh has one.  The identity without a mesh (``mesh``,
    default the ambient one) or without a "data" axis.  ``axes``: the
    gradients' logical axes."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None or "data" not in mesh.axis_names:
        return grads
    if axes is None:
        raise ValueError("constrain_grads_zero1 on a mesh needs the "
                         "gradients' logical axes")

    def one(g, lay):
        g = (C.all_reduce(g, "data", mesh=mesh) if lay.zdim is None else
             C.reduce_scatter(g, "data", dim=lay.zdim, mesh=mesh))
        return C.all_reduce(g, "pod", mesh=mesh)
    return zip_map(one, grads, zero_layout(grads, axes, mesh))


def reduce_grads(grads, mesh=None):
    """Each leaf's local gradient summed over the batch's axes ("data",
    then "pod") by ``all_reduce``, whole (no ZeRO-2)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None:
        return grads

    def one(g):
        for a in ("data", "pod"):
            g = C.all_reduce(g, a, mesh=mesh)
        return g
    return tree_map(one, grads)


def state_shardings(params, axes, mesh, cfg: OptimConfig) -> AdamState:
    """:class:`~repro_torch.distributed.sharding.NamedSharding` of every
    leaf of :func:`init_opt_state`'s state on ``mesh`` (the ZeRO specs;
    the step counter None: the host's), for elastic checkpoints."""
    def one(p, lay):
        return NamedSharding(mesh, lay.zspec)
    lay = zero_layout(params, axes, mesh)
    mu = zip_map(one, params, lay)
    ef = mu if cfg.grad_compression == "int8_ef" else ()
    return AdamState(step=None, mu=mu, nu=mu, ef=ef)
