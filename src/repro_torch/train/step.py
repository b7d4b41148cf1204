"""The train step: loss → gradients (microbatched) → AdamW update.

Counterpart of ``repro/train/step.py``.  Autograd takes the reference's
``jax.value_and_grad``: the gradients are those of the parameter tree's
leaves (``torch.autograd.grad``; the leaves are made to require grad), so
with stacked parameters (``lm.init_params(stacked=True)``) there is one
gradient a reference leaf.  On CUDA tensors every attention's forward is
K6 and its backward K7.  A Python loop over microbatches takes the
reference's ``lax.scan``: each microbatch's gradients are rounded as the
compression says and divided by ``grad_accum`` before they are added to
the accumulator, which is bfloat16 under ``grad_compression="bf16"`` and
float32 otherwise.  Without microbatches the gradients stay in the
parameters' dtype (bfloat16 under compression) and the update casts each
leaf to float32 in its turn: the reference's float32 tree has the same
values.

On a ("data", "model") mesh (``launch/mesh.py::use_mesh``; the dense
and hybrid families, stacked parameters as ``lm.param_axes`` places
them) the batch
is the global batch, the same on every rank: each microbatch is the
reference's (a reshape to (grad_accum, B/grad_accum)), and each "data"
rank takes its rows of it.  The layers run tensor-parallel over "model"
and the loss is the microbatch's global mean on every rank; each
microbatch's gradients are reduced over "data" once, by
``reduce_scatter`` into the ZeRO slice with ``shard_grads`` (the
accumulator then holds only that slice) and by ``all_reduce`` without
it; under ``grad_compression="bf16"`` the tensors handed to the
collective and the accumulator are bfloat16.  ``apply_updates`` then
runs ZeRO-1.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import data_axes, get_abstract_mesh
from repro_torch.models import lm
from repro_torch.models import whisper as wh
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import (AdamState, OptimConfig, apply_updates,
                                     constrain_grads_zero1, reduce_grads,
                                     tree_leaves, tree_map)

Tensor = torch.Tensor


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    if cfg.family == "encdec":
        return wh.lm_loss(params, cfg, batch)
    return lm.lm_loss(params, cfg, batch)


def _cast_grads(grads, mode: str):
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    return grads


def _value_and_grad(params, cfg: ModelConfig, batch) -> Tuple[Tensor, Any]:
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def accumulator(params, compression: str = "none"):
    """The microbatches' gradient sum, zeros: bfloat16 under
    ``compression="bf16"``, float32 otherwise."""
    acc_dt = torch.bfloat16 if compression == "bf16" else torch.float32
    return tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                          device=p.device), params)


def accumulate(acc, grads, grad_accum: int) -> None:
    """acc += grads / grad_accum, leaf by leaf in place, in acc's dtype."""
    for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
        a.add_(g.to(a.dtype) / grad_accum)


def compute_grads(params, cfg: ModelConfig, batch, *, grad_accum: int = 1,
                  compression: str = "none", shard_grads: bool = True):
    """(loss, grads) with optional microbatch accumulation: microbatch i
    is rows [i·B/grad_accum, (i+1)·B/grad_accum) of every batch entry, as
    the reference's reshape, and a "data" rank takes its share of those
    rows (off a mesh: one rank, all of them).  ``shard_grads`` acts on a
    mesh only (see the module's docstring)."""
    mesh = get_abstract_mesh()
    if mesh is not None:
        mesh = lm.mesh_for(cfg)
        if not any(isinstance(params.get(k), dict) for k in lm.STACKS):
            raise ValueError("on a mesh the train step takes stacked "
                             "parameters (lm.init_params(stacked=True))")
        axes = lm.param_axes(cfg)
    shards, idx = 1, 0
    for a in (() if mesh is None else data_axes(mesh)):
        shards, idx = (shards * mesh.axis_size(a),
                       idx * mesh.axis_size(a) + mesh.coords[a])
    rows = next(iter(batch.values())).shape[0]
    ga = max(grad_accum, 1)
    if rows % (ga * shards):
        raise ValueError(f"batch of {rows} rows does not split into {ga} "
                         f"microbatches over {shards} data ranks")
    mb = rows // ga
    mine = mb // shards
    acc = lsum = None
    for i in range(ga):
        lo = i * mb + idx * mine
        micro = {k: v[lo:lo + mine] for k, v in batch.items()}
        if mesh is not None:
            micro = {k: v.to(mesh.device) for k, v in micro.items()}
        loss, grads = _value_and_grad(params, cfg, micro)
        grads = _cast_grads(grads, compression)
        if mesh is not None:
            grads = (constrain_grads_zero1(grads, mesh, axes) if shard_grads
                     else reduce_grads(grads, mesh))
        if ga == 1:
            return loss, grads
        if acc is None:
            acc = accumulator(grads, compression)
        accumulate(acc, grads, ga)
        del grads
        part = loss / ga
        lsum = part if lsum is None else lsum + part
    return lsum, acc


def train_step(params, opt_state: AdamState, batch, *, cfg: ModelConfig,
               opt_cfg: OptimConfig, grad_accum: int = 1
               ) -> Tuple[Any, AdamState, Dict[str, Any]]:
    """One step, the parameters and moments updated in place (and
    returned).  Metrics: ``loss`` and ``grad_norm`` (0-dim float32 tensors
    on the device; reading them synchronizes) and ``lr`` (a float)."""
    loss, grads = compute_grads(params, cfg, batch, grad_accum=grad_accum,
                                compression=opt_cfg.grad_compression,
                                shard_grads=opt_cfg.shard_grads)
    axes = None if get_abstract_mesh() is None else lm.param_axes(cfg)
    new_params, new_state, metrics = apply_updates(params, grads,
                                                   opt_state, opt_cfg, axes)
    return new_params, new_state, dict(metrics, loss=loss)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimConfig,
                    grad_accum: int = 1):
    """fn(params, opt_state, batch) → (params, opt_state, metrics)."""
    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg=cfg,
                          opt_cfg=opt_cfg, grad_accum=grad_accum)
    return step
