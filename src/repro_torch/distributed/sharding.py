"""Sharding rules of the port: the logical-axis ``pspec`` and the fleet's
slot-axis shards.

Counterpart of ``repro/distributed/sharding.py``.  :func:`pspec` maps
logical axis names onto mesh axes, greedy and shape-aware, and returns
the spec as a tuple (``jax.sharding.PartitionSpec``'s entries).  The
fleet half places stacked study state: every leaf leads with the slot
axis, which splits into ``rows``-row shards, shard ``d`` on the mesh's
device ``d`` (:func:`fleet_shard`, the counterpart of ``device_put`` with
``fleet_sharding``), and :func:`shard_map` runs a slot-local program
once per shard, as the reference's ``shard_map`` over ``P("study")``.

``Boxed``, ``param_pspecs``, ``param_shardings``, ``constrain`` and
``get_abstract_mesh`` annotate and constrain an LM's parameters and
activations on a tensor- and data-parallel mesh: they wait for the LM
half of ROADMAP queue A item 9b.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
