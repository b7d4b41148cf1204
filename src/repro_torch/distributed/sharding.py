"""Sharding rules of the port: the logical-axis ``pspec``, the LM's
parameters and activations on a tensor- and data-parallel mesh, and the
fleet's slot-axis shards.

Counterpart of ``repro/distributed/sharding.py``.  :func:`pspec` maps
logical axis names onto mesh axes, greedy and shape-aware, and returns
the spec as a tuple (``jax.sharding.PartitionSpec``'s entries).

The LM half: a :class:`Boxed` leaf carries a value with its logical axes
(:func:`box`, :func:`unbox`, :func:`boxed_axes`); :func:`param_pspecs`
and :func:`param_shardings` place such a tree on a
:class:`~repro_torch.launch.mesh.ProcessMesh`, whose ranks each hold
their own slice of every leaf as a plain tensor.  :func:`shard_tree`
takes global tensors to this rank's slices (the counterpart of
``device_put`` with a ``NamedSharding``) and :func:`gather_tree` gathers
them back (checkpoints, tests).  The ambient mesh is set by
``launch/mesh.py::use_mesh`` and read by :func:`get_abstract_mesh`;
without one :func:`constrain` is the identity and no layer issues a
collective.  On a mesh, :func:`constrain` checks that a tensor's local
shape is the shard of its logical shape (a layout mismatch raises instead
of computing on the wrong slice); the layers place their collectives
themselves (``distributed/collectives.py``).

The fleet half places stacked study state: every leaf leads with the
slot axis, which splits into ``rows``-row shards, shard ``d`` on the
mesh's device ``d`` (:func:`fleet_shard`, the counterpart of
``device_put`` with ``fleet_sharding``), and :func:`shard_map` runs a
slot-local program once per shard, as the reference's ``shard_map``
over ``P("study")``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

# Per logical axis: ordered mesh-axis candidates (first match wins).
AXIS_CANDIDATES = {
    "batch": ("pod", "data"),            # training/prefill activations
    "batch_full": ("pod", "data", "model"),  # decode batches spill to model
    "seq": ("seq",),                     # reserved (SP uses explicit rules)
    "seq_sp": ("model",),                # Megatron-SP residual stream
    "kv_seq": ("data",),                 # long-context decode KV sharding
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head": ("model",),                  # fallback when kv_heads indivisible
    "ff": ("model",),
    "experts": ("model",),
    "lru": ("model",),
    "embed": (),
    None: (),
}


def pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
          mesh_axis_names: Sequence[str],
          mesh_shape: Optional[dict] = None) -> Tuple:
    """Greedy shape-aware logical→mesh mapping.

    Each mesh axis is used at most once per tensor; a dim takes as many of
    its candidate axes as divide it (in order).  An entry is ``None``, a
    mesh axis name, or a tuple of names.
    """
    if mesh_shape is None:
        mesh_shape = {}
    used = set()
    out = []
    for size, name in zip(shape, axes):
        assigned: list = []
        rem = size
        for cand in AXIS_CANDIDATES.get(name, ()):
            if cand in used or cand not in mesh_axis_names:
                continue
            ax_size = mesh_shape.get(cand, 1)
            if ax_size > 1 and rem % ax_size == 0:
                assigned.append(cand)
                used.add(cand)
                rem //= ax_size
        out.append(tuple(assigned) if len(assigned) > 1
                   else (assigned[0] if assigned else None))
    return tuple(out)


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

# one ambient mesh a process, not a ContextVar: autograd runs a CUDA
# graph's backward, and so remat's recompute of a layer's forward, on a
# device thread of its own, which would not see a ContextVar set in the
# caller's thread (the recompute's collectives would vanish)
_MESH: List[Any] = [None]


def get_abstract_mesh():
    """The ambient mesh (``launch/mesh.py::use_mesh``), or None, in every
    thread of the process."""
    return _MESH[0]


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a batch's rows split over ("batch"'s candidates,
    ``pod`` then ``data``) that ``mesh`` has with more than one rank."""
    return tuple(a for a in AXIS_CANDIDATES["batch"]
                 if mesh.axis_size(a) > 1)


def require_no_mesh(what: str) -> None:
    """Raise when an ambient mesh is set: ``what`` does not run on one."""
    if get_abstract_mesh() is not None:
        raise NotImplementedError(
            f"{what} on a mesh waits for ROADMAP queue A item 9b")


# ---------------------------------------------------------------------------
# boxed parameters: value + logical axes travel together
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Boxed:
    """A parameter leaf annotated with logical axis names."""
    value: Any
    axes: Tuple[Optional[str], ...]


def box(value, *axes) -> Boxed:
    return Boxed(value, tuple(axes))


def is_boxed(x) -> bool:
    return isinstance(x, Boxed)


def _map(fn: Callable, tree, is_leaf: Callable):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map(fn, v, is_leaf) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return fn(tree)


def unbox(tree):
    """Strip Boxed wrappers → the plain tree of values."""
    return _map(lambda b: b.value if is_boxed(b) else b, tree, is_boxed)


def boxed_axes(tree):
    """Same-structure tree of logical-axes tuples."""
    return _map(lambda b: b.axes if is_boxed(b) else b, tree, is_boxed)


def zip_map(fn: Callable, tree, other):
    """``fn(leaf, other's entry at the leaf's place)`` over the tensor
    leaves of a dict / list / tuple tree; ``other`` has the tree's
    structure down to each leaf (its entries there may be tuples)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [zip_map(fn, v, other[i]) for i, v in enumerate(tree)]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return fn(tree, other)


def _entries(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh: dim i of a global tensor splits over
    the mesh axes ``spec[i]`` (None, a name, or a tuple of names, the
    first the slowest), each rank holding the slice at its coordinates.
    A spec shorter than the tensor replicates the trailing dims."""
    mesh: Any
    spec: Tuple

    def _parts(self, ndim: int):
        for dim, entry in enumerate(tuple(self.spec)[:ndim]):
            axes = _entries(entry)
            if axes:
                n = math.prod(self.mesh.axis_size(a) for a in axes)
                idx = 0
                for a in axes:
                    idx = idx * self.mesh.axis_size(a) + self.mesh.coords[a]
                yield dim, axes, n, idx

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim, axes, n, _ in self._parts(len(shape)):
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split over {axes} ({n} ranks)")
            out[dim] //= n
        return tuple(out)

    def shard(self, x) -> Tensor:
        """This rank's slice of the global ``x``, a copy on the mesh's
        device."""
        x = torch.as_tensor(x)
        local = self.local_shape(x.shape)
        for dim, _, _, idx in self._parts(x.ndim):
            x = x.narrow(dim, idx * local[dim], local[dim])
        return x.to(self.mesh.device, copy=True).contiguous()

    def gather(self, x: Tensor) -> Tensor:
        """The global tensor from every rank's slice ``x`` (a collective:
        every rank of the mesh calls it)."""
        from repro_torch.distributed import collectives as C
        for dim, axes, _, _ in self._parts(x.ndim):
            for a in reversed(axes):
                x = C.all_gather(x, a, dim=dim, mesh=self.mesh)
        return x


def param_pspecs(tree, mesh):
    """Partition-spec tree for a Boxed tree on ``mesh``."""
    return _map(lambda b: pspec(b.value.shape, b.axes, mesh.axis_names,
                                mesh.sizes), tree, is_boxed)


def param_shardings(tree, mesh):
    """:class:`NamedSharding` tree for a Boxed tree on ``mesh``."""
    return _map(lambda b: NamedSharding(
        mesh, pspec(b.value.shape, b.axes, mesh.axis_names, mesh.sizes)),
        tree, is_boxed)


def shard_tree(tree, axes, mesh):
    """Global tensors → this rank's slices on ``mesh`` (the device_put of
    each leaf with its logical ``axes``' sharding); ``axes`` has the
    tree's structure, a tuple at each leaf."""
    return zip_map(lambda x, ax: NamedSharding(
        mesh, pspec(x.shape, ax, mesh.axis_names, mesh.sizes)).shard(x),
        tree, axes)


def gather_tree(tree, axes, mesh=None):
    """The inverse of :func:`shard_tree`: every rank's slices → the
    global tensors, on every rank (a collective).  An entry of ``axes``
    is a leaf's :class:`NamedSharding`, or its logical axes: then each
    named dim is taken to split over every candidate axis the mesh has,
    which holds for axes :func:`resolve_axes` gave (``lm.param_axes`` on
    a mesh: a head dim sharded where kv_heads do not divide "model", an
    "lru" dim)."""
    def one(x, ax):
        if isinstance(ax, NamedSharding):
            return ax.gather(x)
        return leaf_sharding(x.shape, ax, mesh).gather(x)
    return zip_map(one, tree, axes)


def leaf_sharding(local_shape: Sequence[int], axes, mesh) -> NamedSharding:
    """The :class:`NamedSharding` of a local slice of ``local_shape``
    with logical ``axes`` (resolved for the mesh: :func:`resolve_axes`)."""
    return NamedSharding(mesh, pspec(global_shape(local_shape, axes, mesh),
                                     axes, mesh.axis_names, mesh.sizes))


def local_shardings(tree, axes, mesh):
    """:func:`leaf_sharding` of every local leaf of ``tree`` (logical
    ``axes`` beside it): what a checkpoint of this rank's slices needs."""
    return zip_map(lambda x, ax: leaf_sharding(x.shape, ax, mesh), tree,
                   axes)


def resolve_axes(shape: Sequence[int], axes, mesh) -> Tuple:
    """``axes`` of a leaf of global ``shape`` with every logical name that
    could take a mesh axis of ``mesh`` but that :func:`pspec` gives none
    replaced by None: the same spec, and one that :func:`global_shape`
    reads back exactly from a local shard.  (A local (d, 1, 128) of
    ("embed", "kv_heads", "head") on a model axis of 2 is the shard of
    (d, 2, 128) or of (d, 1, 256); once "kv_heads" is None where one kv
    head does not split, only the second.)  A name that takes some of its
    candidate axes but not all raises: no local shape could say which."""
    spec = pspec(shape, axes, mesh.axis_names, mesh.sizes)
    out = []
    for name, entry in zip(axes, spec):
        got = _entries(entry)
        want = [a for a in AXIS_CANDIDATES.get(name, ())
                if a in mesh.axis_names and mesh.axis_size(a) > 1]
        if want and not got:
            out.append(None)
            continue
        if set(got) != set(want):
            raise ValueError(f"{name!r} of {tuple(shape)} takes {got} of "
                             f"the mesh's {want}")
        out.append(name)
    return tuple(out)


def global_shape(local: Sequence[int], axes, mesh) -> Tuple[int, ...]:
    """The global shape whose :func:`pspec` shard is ``local``: each dim
    takes the candidates :func:`pspec` would give it, greedy, in order
    (a dim that splits has size local × ranks; pspec of the result
    assigns the same axes, since divisibility holds by construction)."""
    used, out = set(), []
    for size, name in zip(local, axes):
        n = 1
        for cand in AXIS_CANDIDATES.get(name, ()):
            k = mesh.axis_size(cand) if cand in mesh.axis_names else 1
            if cand not in used and k > 1:
                used.add(cand)
                n *= k
        out.append(size * n)
    return tuple(out)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def constrain(x: Tensor, *axes: Optional[str],
              shape: Optional[Sequence[Optional[int]]] = None,
              mesh=None) -> Tensor:
    """``x`` itself; off a mesh nothing is checked.  On the ambient mesh
    (or on ``mesh``) ``x`` must be the shard of a tensor with logical
    ``axes`` and logical ``shape`` (None entries, or no ``shape``, leave a
    dim unchecked): each checked dim's local size is its logical size
    over the ranks of the mesh axes :func:`pspec` gives it.  A mismatch
    raises ValueError."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if mesh is None or shape is None:
        return x
    known = [(i, s, a) for i, (s, a) in enumerate(zip(shape, axes))
             if s is not None]
    spec = pspec([s for _, s, _ in known], [a for _, _, a in known],
                 mesh.axis_names, mesh.sizes)
    for (i, s, a), entry in zip(known, spec):
        n = math.prod(mesh.axis_size(e) for e in _entries(entry))
        if x.shape[i] * n != s:
            raise ValueError(
                f"dim {i} ({a!r}) of a tensor of local shape "
                f"{tuple(x.shape)} is not the shard of {s} over "
                f"{_entries(entry) or 'no mesh axis'} ({n} ranks)")
    return x


# ---------------------------------------------------------------------------
# the fleet: stacked study state, split along its leading slot axis
# ---------------------------------------------------------------------------

FLEET_AXIS = "study"


def fleet_pspec(ndim: int, axis: str = FLEET_AXIS) -> Tuple:
    """Leading-study-axis spec: ``(axis, None, ...)`` for an ndim-leaf."""
    if ndim < 1:
        raise ValueError("fleet state leaves must have a leading study axis")
    return (axis,) + (None,) * (ndim - 1)


@dataclasses.dataclass
class Sharded:
    """A stacked leaf split along its leading slot axis into equal row
    shards, shard ``d`` on mesh device ``d``.  Indexing with a leading
    slot (``x[slot]``, ``x[slot, i]``) reads or writes that row on the
    shard that owns it; :meth:`cpu` gathers the whole leaf."""
    shards: List[Tensor]

    @property
    def rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.rows * len(self.shards),)
                + tuple(self.shards[0].shape[1:]))

    def _locate(self, idx) -> Tuple[Tensor, tuple]:
        slot, rest = (idx[0], idx[1:]) if isinstance(idx, tuple) else (idx,
                                                                        ())
        slot = int(slot)
        if not 0 <= slot < self.rows * len(self.shards):
            raise IndexError(f"slot {slot} out of range for {self.shape}")
        d, r = divmod(slot, self.rows)
        return self.shards[d], (r,) + rest

    def __getitem__(self, idx) -> Tensor:
        shard, i = self._locate(idx)
        return shard[i]

    def __setitem__(self, idx, value) -> None:
        shard, i = self._locate(idx)
        shard[i] = torch.as_tensor(value, dtype=shard.dtype,
                                   device=shard.device)

    def cpu(self) -> Tensor:
        return torch.cat([s.cpu() for s in self.shards])

    def numpy(self):
        return self.cpu().numpy()


def fleet_shard(mesh, x, rows: int) -> Sharded:
    """Split ``x`` (a tensor or array whose leading axis is
    ``rows × mesh.size``) into ``rows``-row shards, each copied to its
    mesh device."""
    x = torch.as_tensor(x)
    if x.ndim < 1 or x.shape[0] != rows * mesh.size:
        raise ValueError(f"a leaf of {tuple(x.shape)} does not split into "
                         f"{mesh.size} shards of {rows} rows")
    return Sharded([x[d * rows:(d + 1) * rows].to(dev, copy=True)
                    for d, dev in enumerate(mesh.devices)])


def fleet_shards(mesh, tree, rows: int):
    """:func:`fleet_shard` over every tensor leaf of a tuple, list or dict
    tree; ``None`` and other leaves pass through."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(fleet_shards(mesh, t, rows) for t in tree)
    if isinstance(tree, dict):
        return {k: fleet_shards(mesh, v, rows) for k, v in tree.items()}
    if isinstance(tree, Tensor):
        return fleet_shard(mesh, tree, rows)
    return tree


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _join(outs: List[Any]):
    """Per-shard results → one result: tensors join into a
    :class:`Sharded`, other leaves into the list of the shards' values."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_join(list(o)) for o in zip(*outs))
    if isinstance(first, dict):
        return {k: _join([o[k] for o in outs]) for k in first}
    if first is None:
        return None
    if isinstance(first, Tensor):
        return Sharded(list(outs))
    return list(outs)


def shard_map(fn: Callable, mesh) -> Callable:
    """``fn`` once per shard, in mesh order, under its device: a
    :class:`Sharded` argument passes its shard, any other argument passes
    whole.  Each shard runs the same slot-local program on its own rows
    (nothing is reduced across shards), so a study's bits do not depend
    on the mesh."""
    def run(*args):
        outs = []
        for d, dev in enumerate(mesh.devices):
            local = [a.shards[d] if isinstance(a, Sharded) else a
                     for a in args]
            with _on(dev):
                outs.append(fn(*local))
        return _join(outs)
    return run
