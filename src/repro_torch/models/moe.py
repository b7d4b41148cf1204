"""Mixture-of-Experts block: top-k routing and GShard capacity dispatch.

Counterpart of the local (no mesh) path of ``repro/models/moe.py``: every
expert's weights on one device, tokens gathered into an (E, C, D)
capacity buffer, the experts' SwiGLU FFN as three batched products over
all E experts (the reference's einsums), the outputs combined back to
their tokens gate-weighted.  Each expert accepts at most ``C =
max(ceil(N·k/E · capacity_factor), 1)`` of the N·k (token, expert) pairs,
in token-major order; the rest drop (their gate mass is lost).  A token's
output therefore depends on the batch it rides in, as in the reference.

Bit-level rules the port keeps: the router weight is float32 in every
model dtype and the logits and softmax are float32; top-k breaks ties
toward the lower expert index (``lax.top_k``'s order) by a stable
descending sort; the combine adds a token's k contributions in k order in
the model dtype (the reference's scatter-add order, zero for a dropped
pair), with no atomics, so a row's output is the same run to run.
Expert parallelism over a mesh is ROADMAP queue A item 9b.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, draw_device

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Dict[str, Tensor]:
    """Router (d, E) float32 and experts ``w_up``/``w_gate`` (E, d, ff),
    ``w_down`` (E, ff, d) in ``dtype``, normal · fan_in^−½."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = draw_device(gen, device)
    return {
        "router": _dense_init(gen, lead + (d, E), torch.float32, d, dev),
        "w_up": _dense_init(gen, lead + (E, d, ff), dtype, d, dev),
        "w_gate": _dense_init(gen, lead + (E, d, ff), dtype, d, dev),
        "w_down": _dense_init(gen, lead + (E, ff, d), dtype, ff, dev),
    }


def _expert_ffn(w_up: Tensor, w_gate: Tensor, w_down: Tensor, xs: Tensor
                ) -> Tensor:
    """xs: (E, C, D) → (E, C, D), each expert's SwiGLU on its rows."""
    h = torch.bmm(xs, w_up)
    g = torch.bmm(xs, w_gate)
    return torch.bmm(F.silu(g) * h, w_down)


def _route(x_flat: Tensor, router_w: Tensor, k: int
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Router probabilities (N, E) float32, and each token's k gates
    (renormalized) and experts, ties toward the lower expert index."""
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    # stable descending sort: ties keep the lower expert first (lax.top_k)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _local_moe(x_flat: Tensor, router_w: Tensor, w_up: Tensor,
               w_gate: Tensor, w_down: Tensor, *, k: int,
               n_experts_global: int, e_start: int, capacity: int
               ) -> Tuple[Tensor, Tensor]:
    """Dispatch N tokens x_flat (N, D) to the experts ``w_*`` (E_loc, ...)
    covering global ids [e_start, e_start + E_loc).  Returns (y (N, D),
    aux load-balance loss)."""
    n, d = x_flat.shape
    e_loc = w_up.shape[0]
    E = n_experts_global
    dev = x_flat.device

    probs, gate_vals, expert_idx = _route(x_flat, router_w, k)
    me = probs.mean(0)                                             # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(1).mean(0)
    aux = E * (me * ce).sum()

    # each pair's slot within its expert: exclusive cumsum, token-major
    flat_e = expert_idx.reshape(-1)                                # (N·k,)
    flat_g = gate_vals.reshape(-1)
    local_e = flat_e - e_start
    mine = (local_e >= 0) & (local_e < e_loc)
    local_e = local_e.clamp(0, e_loc - 1)
    onehot = F.one_hot(local_e, e_loc) * mine[:, None]             # (N·k, E)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(1)
    keep = mine & (pos < capacity)
    spill = e_loc * capacity
    slot = torch.where(keep, local_e * capacity + pos, spill)
    token_id = torch.arange(n * k, device=dev) // k

    # gather tokens into the capacity buffer (the spill row is dropped)
    src = torch.zeros(spill + 1, dtype=torch.long, device=dev)
    src[slot] = token_id
    filled = torch.zeros(spill + 1, dtype=torch.bool, device=dev)
    filled[slot] = keep
    xs = x_flat[src[:-1]] * filled[:-1, None].to(x_flat.dtype)
    ys = _expert_ffn(w_up, w_gate, w_down, xs.reshape(e_loc, capacity, d))
    ys = ys.reshape(spill, d)

    # combine: a token's k contributions added in k order, 0 for a drop
    contrib = torch.where(keep, flat_g, 0.0).to(ys.dtype)
    parts = (ys[torch.where(keep, slot, 0)] * contrib[:, None]).view(n, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y, aux


def apply_moe(p: Dict[str, Tensor], cfg: ModelConfig, x: Tensor,
              mesh=None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) → (y (B, S, D), aux loss), every expert local."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh waits for ROADMAP queue A "
            "item 9b")
    b, s, d = x.shape
    k, E = cfg.experts_per_token, cfg.n_experts
    cap = max(int(math.ceil(b * s * k / E * cfg.moe_capacity_factor)), 1)
    y, aux = _local_moe(x.reshape(b * s, d), p["router"], p["w_up"],
                        p["w_gate"], p["w_down"], k=k, n_experts_global=E,
                        e_start=0, capacity=cap)
    return y.reshape(b, s, d), aux
