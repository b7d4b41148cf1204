"""AdamW (no optimizer library) with the reference's gradient-compression
options.

Counterpart of ``repro/train/optim.py``, on one device.  The update keeps
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
host from a host step counter, so a step reads no device value.  The
reference's ZeRO-1 and gradient sharding act only on a mesh; ``zero1``
and ``shard_grads`` stay in :class:`OptimConfig` so a config reads the
same in both packages, and a mesh raises (ROADMAP queue A item 9b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------- state
def init_opt_state(params, cfg: OptimConfig) -> AdamState:
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


def _int8_ef(g: Tensor, ef: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(int8 q, its scale, the new residual) of g + ef."""
    gc = g.float() + ef
    scale = torch.clamp(gc.abs().max(), min=1e-12) / 127.0
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


def global_norm(tree) -> Tensor:
    """sqrt(Σ over leaves, in the reference's order, of Σ x²), float32."""
    return _norm(tree_leaves(tree))


def apply_updates(params, grads, state: AdamState, cfg: OptimConfig
                  ) -> Tuple[Any, AdamState, Dict[str, Any]]:
    """One AdamW step, in place: ``params``' leaves and the state's
    moments (and ``ef``) are overwritten, and returned.  ``grads`` has
    ``params``' structure, in any float dtype.  Metrics: ``grad_norm`` (a
    0-dim float32 tensor on the gradients' device) and ``lr`` (a float)."""
    step = state.step + 1
    lr = lr_schedule(cfg, int(step))
    with torch.no_grad():
        g_leaves = tree_leaves(grads)
        if cfg.grad_compression == "int8_ef":
            # each leaf kept as int8 and its scale, the residual written
            # in place; the norm and the update dequantize it (same bits)
            packed = []
            for g, e in zip(g_leaves, tree_leaves(state.ef)):
                q, scale, res = _int8_ef(g, e)
                e.copy_(res)
                packed.append((q, scale))

            def grad(i):
                return packed[i][0].float() * packed[i][1]
        else:
            def grad(i):
                return g_leaves[i]
        n = len(g_leaves)
        gnorm = _norm(grad(i) for i in range(n))
        clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if cfg.grad_clip > 0 else None)
        t = np.float32(int(step))
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
        for i, (p, mu, nu) in enumerate(zip(tree_leaves(params),
                                            tree_leaves(state.mu),
                                            tree_leaves(state.nu))):
            g32 = grad(i).float()
            if clip is not None:
                g32 = g32 * clip
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            del g32
            delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            delta.add_(cfg.weight_decay * p.float())
            p.copy_(p.float().sub_(lr * delta))
            del delta
    new_state = AdamState(step=step, mu=state.mu, nu=state.nu, ef=state.ef)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 (a mesh's optimizer-state sharding): not on one device
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


def constrain_grads_zero1(grads, mesh=None):
    """Identity on one device (the reference's off a mesh); a mesh is not
    ported."""
    if mesh is not None:
        raise NotImplementedError(
            "training across several cards (mesh=) is not ported yet: "
            "ROADMAP queue A item 9b")
    return grads
