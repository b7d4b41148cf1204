"""Collectives over one axis of a :class:`~repro_torch.launch.mesh.
ProcessMesh`, and Megatron's pair of autograd operators.

Every function takes the mesh axis by name and the mesh (default: the
ambient one, ``sharding.get_abstract_mesh``); over an axis of one rank,
or with no mesh, it returns its input and issues nothing, so the
one-card path runs as it did.

:func:`all_reduce`, :func:`all_gather` and :func:`reduce_scatter` are
out of place and carry no gradient (the autograd forms are below).
The backend follows from the layout
(``launch/mesh.py::collective_backend``): NCCL takes every
collective on the card; gloo, which ranks sharing a card use, takes a
CUDA tensor for ``all_reduce`` (and ``broadcast``) only, so
:func:`all_gather` stages a CUDA tensor through the host there, and
:func:`reduce_scatter` is built from ``all_reduce`` and this rank's
slice (the same sum, twice the bytes on the wire).

Two autograd layout changes carry gradients across a sharded dim:
:func:`gather_from` (an all-gather along a dim, whose backward is the
reduce-scatter of the gradient on that dim: each rank's use of the
gathered tensor gives part of every slice's gradient) and
:func:`scatter_to` (a reduce-scatter, whose backward all-gathers the
gradient).  The head-dim-sharded attention gathers k and v with the
first, and the RG-LRU's "lru"-parallel gate products scatter their
partial sums with the second (``models/layers.py``, ``models/rglru.py``).

The autograd pair (Megatron-LM's *f* and *g*) brackets a
tensor-parallel product:

* :func:`copy_to` (*f*): identity forward, all-reduce backward, at the
  input of a column-parallel product: each rank's slice of the weight
  gives part of the input's gradient;
* :func:`reduce_from` (*g*): all-reduce forward, identity backward,
  after a row-parallel product, and wherever a replicated result is
  summed from per-rank parts (the vocab-sharded loss).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import get_abstract_mesh

Tensor = torch.Tensor

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _axis(axis: str, mesh):
    """(mesh, group, ranks along ``axis``), or None where nothing is to
    be done (no mesh, or one rank on the axis)."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None or mesh.axis_size(axis) == 1:
        return None
    return mesh, mesh.groups[axis], mesh.axis_size(axis)


def _host(mesh, x: Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def all_reduce(x: Tensor, axis: str, op: str = "sum", mesh=None) -> Tensor:
    """The sum (or max) of ``x`` over the ranks of ``axis``, every rank
    receiving the same bits."""
    got = _axis(axis, mesh)
    if got is None:
        return x
    _, group, _ = got
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def all_gather(x: Tensor, axis: str, dim: int = 0, mesh=None) -> Tensor:
    """The ranks' ``x`` along ``axis``, concatenated along ``dim`` in the
    axis's order."""
    got = _axis(axis, mesh)
    if got is None:
        return x
    mesh, group, n = got
    src = x.detach().contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device) \
            if dim == 0 else None
        if out is not None:
            dist.all_gather_into_tensor(out, src, group=group)
            return out
    host = _host(mesh, src)
    s = src.cpu() if host else src
    parts = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(parts, s, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if host else out


def reduce_scatter(x: Tensor, axis: str, dim: int = 0, mesh=None) -> Tensor:
    """This rank's slice along ``dim`` of the sum of ``x`` over the ranks
    of ``axis`` (``dim`` splits into one equal slice a rank, in the
    axis's order)."""
    got = _axis(axis, mesh)
    if got is None:
        return x
    mesh, group, n = got
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    size = x.shape[dim] // n
    idx = mesh.coords[axis]
    if mesh.backend == "nccl":
        src = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((size,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    total = all_reduce(x, axis, mesh=mesh)
    return total.narrow(dim, idx * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x, axis, dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.axis, dim=ctx.dim, mesh=ctx.mesh),
                None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return reduce_scatter(x, axis, dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.axis, dim=ctx.dim,
                           mesh=ctx.mesh), None, None, None)


def gather_from(x: Tensor, axis: str = "model", dim: int = -1,
                mesh=None) -> Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` (every rank
    gets the whole), differentiable: the gradient is reduce-scattered
    back on ``dim``.  ``x`` itself off a mesh."""
    got = _axis(axis, mesh)
    return x if got is None else _GatherFrom.apply(x, axis, dim % x.ndim,
                                                   got[0])


def scatter_to(x: Tensor, axis: str = "model", dim: int = -1,
               mesh=None) -> Tensor:
    """This rank's slice on ``dim`` of the sum of ``x`` over ``axis``,
    differentiable: the gradient is all-gathered back on ``dim``.  ``x``
    itself off a mesh."""
    got = _axis(axis, mesh)
    return x if got is None else _ScatterTo.apply(x, axis, dim % x.ndim,
                                                  got[0])


def copy_to(x: Tensor, axis: str = "model", mesh=None) -> Tensor:
    """Megatron's *f*: ``x`` forward, its gradient summed over ``axis``
    backward."""
    got = _axis(axis, mesh)
    return x if got is None else _CopyTo.apply(x, axis, got[0])


def reduce_from(x: Tensor, axis: str = "model", mesh=None) -> Tensor:
    """Megatron's *g*: ``x`` summed over ``axis`` forward, the gradient
    passed through backward."""
    got = _axis(axis, mesh)
    return x if got is None else _ReduceFrom.apply(x, axis, got[0])


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others: a one-element
    all-reduce over each of its axes."""
    t = torch.zeros(1, device=mesh.device)
    for a in mesh.axis_names:
        t = all_reduce(t, a, mesh=mesh)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
