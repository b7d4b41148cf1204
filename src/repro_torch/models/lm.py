"""The dense decoder-only LM: init, forward, and serving with a KV cache.

Counterpart of the dense family of ``repro/models/lm.py`` (no experts).
Parameters are a dictionary ``{"embed", "final_norm", "blocks"}`` whose
``blocks`` is a list with one dictionary per layer (views of one stacked
tensor per weight when drawn here).  On CUDA tensors every attention is
the flash kernel K6: ``forward`` launches it once per layer with Sq = S,
``decode_step`` once per layer per step over the whole cache.

The cache is preallocated on the device, ``k``/``v`` (L, B, Lmax, KH, hd)
and ``pos`` (L, B, Lmax), and every step writes into it in place (JAX
threads it through a scan carry that XLA aliases).  Other families raise
``NotImplementedError`` (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe or cfg.qk_norm or cfg.window:
        raise NotImplementedError(
            f"the port's LM runs the dense family without experts; "
            f"{cfg.name} ({cfg.family}) waits for ROADMAP A12")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``gen.device``, with the JAX
    package's distributions (dense weights normal · fan_in^−½, token
    embedding normal · 0.02, norm scales ones)."""
    _require_dense(cfg)
    dtype, n = torch_dtype(cfg), cfg.n_layers
    stacked = {
        "attn_norm": L.init_norm(gen, cfg, dtype, (n,)),
        "attn": L.init_attention(gen, cfg, dtype, (n,)),
        "mlp_norm": L.init_norm(gen, cfg, dtype, (n,)),
        "mlp": L.init_mlp(gen, cfg, dtype, (n,)),
    }
    return {
        "embed": L.init_embedding(gen, cfg, dtype),
        "final_norm": L.init_norm(gen, cfg, dtype),
        "blocks": unstack_layers(stacked, n),
    }


def unstack_layers(stacked: Dict[str, Dict[str, Tensor]], n: int
                   ) -> List[Dict[str, Dict[str, Tensor]]]:
    """{sublayer: {name: (n, ...)}} → n per-layer dictionaries of views."""
    return [{sub: {k: t[i] for k, t in d.items()}
             for sub, d in stacked.items()} for i in range(n)]


def param_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every distinct parameter storage."""
    seen, total = set(), 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            st = node.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    walk(params)
    return total


# ---------------------------------------------------------------------------
# forward (no cache)
# ---------------------------------------------------------------------------

def _block(p, cfg: ModelConfig, x: Tensor, positions: Tensor, tables,
           cache=None, cache_index=None):
    h = L.apply_norm(p["attn_norm"], x, cfg.norm)
    a, cache = L.apply_attention(p["attn"], cfg, h, positions, cache=cache,
                                 cache_index=cache_index, tables=tables)
    x = x + a
    h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], cfg, h), cache


def forward(params, cfg: ModelConfig, tokens: Tensor) -> Tuple[Tensor, Tensor]:
    """Teacher-forced inference: tokens (B, S) → (final hidden (B, S, D),
    aux loss 0).  On CUDA each layer's attention is one K6 launch."""
    _require_dense(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s).contiguous()
    tables = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    for p in params["blocks"]:
        x, _ = _block(p, cfg, x, positions, tables)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# serving: decode with a preallocated cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None
               ) -> Dict[str, Tensor]:
    """Stacked per-layer KV cache, all slots empty (position −1), on
    ``device``: ``None`` means the card, as at every entry point
    (``repro_torch.resolve_device``), so pass ``device="cpu"`` on the
    CPU."""
    _require_dense(cfg)
    return L.init_attn_cache(cfg, batch, max_len, torch_dtype(cfg),
                             lead=(cfg.n_layers,),
                             device=resolve_device(device))


def reset_slot(cfg: ModelConfig, cache: Dict[str, Tensor], slot: int
               ) -> Dict[str, Tensor]:
    """Empty one batch slot in place (continuous-batching admission): its
    positions become −1, so the previous occupant's entries can never pass
    the position mask, and its K/V become 0."""
    cache["k"][:, slot] = 0
    cache["v"][:, slot] = 0
    cache["pos"][:, slot] = -1
    return cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor,
                cache: Dict[str, Tensor], position: Union[int, Tensor]
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serving step.  tokens (B, 1); position: () or (B,) int32, each
    row's index of this token (the vector form is continuous batching; a
    row at −1 is idle).  Writes the cache in place and returns
    (logits (B, V), the same cache)."""
    _require_dense(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    b = x.shape[0]
    pos = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    positions = (pos.expand(b, 1) if pos.ndim == 0 else pos[:, None])
    positions = positions.contiguous()
    tables = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    for i, p in enumerate(params["blocks"]):
        layer = {"k": cache["k"][i], "v": cache["v"][i],
                 "pos": cache["pos"][i]}
        x, _ = _block(p, cfg, x, positions, tables, cache=layer,
                      cache_index=pos)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.lm_logits(params["embed"], cfg, x)[:, 0, :], cache
