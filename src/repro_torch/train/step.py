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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import lm
from repro_torch.models import whisper as wh
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import (AdamState, OptimConfig, apply_updates,
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
    the reference's reshape.  ``shard_grads`` acts on a mesh only."""
    if grad_accum <= 1:
        loss, grads = _value_and_grad(params, cfg, batch)
        return loss, _cast_grads(grads, compression)
    rows = next(iter(batch.values())).shape[0]
    if rows % grad_accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{grad_accum} microbatches")
    mb = rows // grad_accum
    acc = accumulator(params, compression)
    lsum = None
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, grads = _value_and_grad(params, cfg, micro)
        accumulate(acc, _cast_grads(grads, compression), grad_accum)
        del grads
        part = loss / grad_accum
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
    new_params, new_state, metrics = apply_updates(params, grads,
                                                   opt_state, opt_cfg)
    return new_params, new_state, dict(metrics, loss=loss)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimConfig,
                    grad_accum: int = 1):
    """fn(params, opt_state, batch) → (params, opt_state, metrics)."""
    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg=cfg,
                          opt_cfg=opt_cfg, grad_accum=grad_accum)
    return step
