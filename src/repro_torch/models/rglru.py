"""Griffin/RecurrentGemma recurrent block: causal conv + RG-LRU.

Counterpart of ``repro/models/rglru.py``.  RG-LRU is a diagonal gated
linear recurrence:

    a_t = exp(−c · softplus(Λ) · σ(r_t))
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (σ(i_t) ⊙ x_t)

The reference runs it as one ``lax.associative_scan`` over the sequence;
the port runs the same recurrence as a sequential float32 loop over S
(one multiply-add a step; a decode step is S = 1, where both are the same
expression).  The two sum in another order, so a prefill differs from the
reference's by float32 rounding only.  ``lambda_param`` and the carried
``h`` are float32 in every model dtype.

On a ("data", "model") mesh the block is tensor-parallel over "lru", as
the reference's axes place it: ``w_gate_in`` and ``w_rec_in`` are
column-parallel (*f*, ``collectives.copy_to``, at the block's input), the
conv, its bias and Λ are channel-local, ``w_rec_gate`` and
``w_input_gate`` hold this rank's rows ("lru", None), so its products are
partial (B, S, W) sums, and one reduce-scatter of both over "model"
(``collectives.scatter_to``) gives each rank its columns; the RG-LRU then
runs on this rank's channels unchanged, and ``w_out`` is row-parallel,
followed by *g* (``collectives.reduce_from``).  The decode state is this
rank's channels, ``conv`` (B, K−1, W/m) and ``h`` (B, W/m).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, _gelu, draw_device

Tensor = torch.Tensor

_C = 8.0      # Griffin's fixed recurrence sharpness constant


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                         lead: Tuple[int, ...] = (), device=None
                         ) -> Dict[str, Tensor]:
    d, w, dev = cfg.d_model, cfg.lru_width, draw_device(gen, device)
    return {
        # two input branches (gate / recurrent)
        "w_gate_in": _dense_init(gen, lead + (d, w), dtype, d, dev),
        "w_rec_in": _dense_init(gen, lead + (d, w), dtype, d, dev),
        "w_out": _dense_init(gen, lead + (w, d), dtype, w, dev),
        # temporal conv (depthwise, width cfg.conv_width)
        "conv_w": _dense_init(gen, lead + (cfg.conv_width, w), dtype,
                              cfg.conv_width, dev),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        # RG-LRU gates
        "w_input_gate": _dense_init(gen, lead + (w, w), dtype, w, dev),
        "w_rec_gate": _dense_init(gen, lead + (w, w), dtype, w, dev),
        "lambda_param": torch.full(lead + (w,), 0.7, dtype=torch.float32,
                                   device=dev),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv.  x: (B, S, W); w: (K, W); ``state``: (B,
    K−1, W) trailing context from the previous segment (decode).  Returns
    (out, new_state)."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                 # (B, S+K−1, W)
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return out + b, new_state


def _rg_lru(x: Tensor, r: Tensor, i: Tensor, lam: Tensor,
            h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x/r/i: (B, S, W) → (h in x's dtype, h_last float32)."""
    log_a = -_C * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i.float()) * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    if h0 is not None:
        # fold the carried state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    hs = [b[:, 0]]
    for t in range(1, x.shape[1]):
        hs.append(a[:, t] * hs[-1] + b[:, t])
    h = torch.stack(hs, dim=1)
    return h.to(x.dtype), hs[-1]


def apply_recurrent_block(p: Dict[str, Tensor], cfg: ModelConfig, x: Tensor,
                          state: Optional[Dict[str, Tensor]] = None
                          ) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """x: (B, S, D) → (y, new_state).  ``state`` carries (``conv`` (B, K−1,
    W), ``h`` (B, W) float32) for decode; new_state is None without it.
    Every row advances, whatever its token (the reference's semantics).
    On a mesh W is this rank's "lru" channels and y is summed over
    "model"."""
    x = C.copy_to(x, "model")
    gate = _gelu(x @ p["w_gate_in"])
    rec = constrain(x @ p["w_rec_in"], "batch", None, "lru",
                    shape=(None, None, cfg.lru_width))
    conv_state = state["conv"] if state is not None else None
    rec, new_conv = _causal_conv(rec, p["conv_w"], p["conv_b"], conv_state)
    # w_rec_gate and w_input_gate hold this rank's rows ("lru", None): the
    # products are partial sums over the whole width, reduce-scattered
    # together (one collective) to this rank's columns
    r, i = C.scatter_to(torch.stack([rec @ p["w_rec_gate"],
                                     rec @ p["w_input_gate"]]), "model",
                        dim=-1)
    h0 = state["h"] if state is not None else None
    h, h_last = _rg_lru(rec, r, i, p["lambda_param"], h0)
    y = C.reduce_from((h * gate) @ p["w_out"], "model")
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "h": h_last}
    return y, new_state


def init_recurrent_state(cfg: ModelConfig, batch: int, dtype,
                         lead: Tuple[int, ...] = (), device=None
                         ) -> Dict[str, Tensor]:
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1,
                                    cfg.lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }
