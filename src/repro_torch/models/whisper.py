"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Counterpart of ``repro/models/whisper.py``.  The encoder takes
precomputed frame embeddings (B, S_enc, d_model) — the conv frontend is a
stub, as in the reference — with sinusoidal positions computed on the fly.
The decoder carries a self-attention KV cache plus the encoder's
cross-attention K/V, computed once in :func:`init_cache`.

Every attention is the flash kernel K6 on CUDA tensors and its plain
version on CPU tensors (``kernels/flash/kernel.py::attention``): the
encoder's self-attention and every cross-attention without the causal
mask, the decoder's self-attention with it.  An :func:`encode` launches
K6 once per encoder layer, :func:`decode_train` and :func:`decode_step`
twice per decoder layer.  Parameters: ``{"embed", "enc", "dec",
"enc_norm", "final_norm"}``, ``enc`` and ``dec`` one dictionary per
layer of views of one stacked tensor per weight when drawn here.
Training (``lm_loss``) waits for ROADMAP A12 item 4.5.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash.kernel import attention
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import torch_dtype, unstack_layers

Tensor = torch.Tensor


def _sinusoidal(positions: Tensor, d: int, dtype) -> Tensor:
    """(…) int positions → (…, d): sin then cos of position · 10000^(−i /
    (d/2 − 1)), in float32 (the step log(10000) / max(d/2 − 1, 1) rounded
    to float32 once), cast to ``dtype``."""
    half = d // 2
    step = math.log(10000.0) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``gen.device`` with the JAX
    package's distributions (see ``lm.init_params``)."""
    dtype = torch_dtype(cfg)
    ne, nd = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    enc = {
        "attn_norm": L.init_norm(gen, cfg, dtype, ne),
        "attn": L.init_attention(gen, cfg, dtype, ne),
        "mlp_norm": L.init_norm(gen, cfg, dtype, ne),
        "mlp": L.init_mlp(gen, cfg, dtype, ne),
    }
    dec = {
        "self_norm": L.init_norm(gen, cfg, dtype, nd),
        "self_attn": L.init_attention(gen, cfg, dtype, nd),
        "cross_norm": L.init_norm(gen, cfg, dtype, nd),
        "cross_attn": L.init_attention(gen, cfg, dtype, nd),
        "mlp_norm": L.init_norm(gen, cfg, dtype, nd),
        "mlp": L.init_mlp(gen, cfg, dtype, nd),
    }
    return {
        "embed": L.init_embedding(gen, cfg, dtype),
        "enc": unstack_layers(enc, cfg.n_enc_layers),
        "dec": unstack_layers(dec, cfg.n_dec_layers),
        "enc_norm": L.init_norm(gen, cfg, dtype),
        "final_norm": L.init_norm(gen, cfg, dtype),
    }


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32,
                        device=device).expand(b, s).contiguous()


def _cross_attend(p, cfg: ModelConfig, x: Tensor, enc_k: Tensor,
                  enc_v: Tensor, enc_pos: Tensor) -> Tensor:
    """Decoder→encoder attention with precomputed encoder K/V: K6 without
    the causal mask (the query positions are unused, 0)."""
    b, s, _ = x.shape
    q = L._project(x, p["wq"]).contiguous()
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    out = attention(q, enc_k, enc_v, q_pos, enc_pos, causal=False)
    wo = p["wo"]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _enc_kv(p, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
    return (L._project(enc_out, p["wk"]).contiguous(),
            L._project(enc_out, p["wv"]).contiguous())


def encode(params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder hidden states."""
    b, s, d = frames.shape
    dt = torch_dtype(cfg)
    pos = _positions(b, s, frames.device)
    x = frames.to(dt) + _sinusoidal(pos, d, dt)
    for p in params["enc"]:
        a = L.apply_norm(p["attn_norm"], x, cfg.norm)
        a, _ = L.apply_attention(p["attn"], cfg, a, pos, causal=False)
        x = x + a
        m = L.apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, m)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def decode_train(params, cfg: ModelConfig, enc_out: Tensor,
                 tokens: Tensor) -> Tensor:
    """Teacher-forced decoder pass → final hidden (B, S_dec, D)."""
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    enc_pos = _positions(b, enc_out.shape[1], enc_out.device)
    for p in params["dec"]:
        a = L.apply_norm(p["self_norm"], x, cfg.norm)
        a, _ = L.apply_attention(p["self_attn"], cfg, a, pos, causal=True)
        x = x + a
        c = L.apply_norm(p["cross_norm"], x, cfg.norm)
        ek, ev = _enc_kv(p["cross_attn"], enc_out)
        x = x + _cross_attend(p["cross_attn"], cfg, c, ek, ev, enc_pos)
        m = L.apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, m)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(params, cfg: ModelConfig, enc_out: Tensor, batch: int,
               max_len: int, device=None) -> Dict[str, Any]:
    """Decoder cache on ``device`` (``None`` means the card, as at every
    entry point; ``enc_out`` must live there): ``self``, the per-layer
    self-attention KV cache (``k``/``v`` (L, B, max_len, KH, hd), ``pos``
    (L, B, max_len), all slots empty), ``cross``, every layer's encoder
    K/V (``k``/``v`` (L, B, S_enc, KH, hd)), and ``enc_pos`` (B, S_enc)."""
    self_cache = L.init_attn_cache(cfg, batch, max_len, torch_dtype(cfg),
                                   lead=(cfg.n_dec_layers,),
                                   device=resolve_device(device))
    dev = self_cache["k"].device
    if enc_out.device != dev:
        raise ValueError(f"enc_out lives on {enc_out.device}, the cache on "
                         f"{dev}")
    return {"self": self_cache, "cross": _cross_all(params, cfg, enc_out),
            "enc_pos": _positions(batch, enc_out.shape[1], dev)}


def _cross_all(params, cfg: ModelConfig, enc_out: Tensor
               ) -> Dict[str, Tensor]:
    kv = [_enc_kv(p["cross_attn"], enc_out) for p in params["dec"]]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache,
                position: int) -> Tuple[Tensor, Any]:
    """One decoder step, every row at the same ``position``.  tokens:
    (B, 1) → (logits (B, V), the same cache, written in place)."""
    b = tokens.shape[0]
    pos = torch.full((b, 1), int(position), dtype=torch.int32,
                     device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    sc, cross = cache["self"], cache["cross"]
    for li, p in enumerate(params["dec"]):
        self_c = {key: sc[key][li] for key in ("k", "v", "pos")}
        a = L.apply_norm(p["self_norm"], x, cfg.norm)
        a, _ = L.apply_attention(p["self_attn"], cfg, a, pos, causal=True,
                                 cache=self_c, cache_index=position)
        x = x + a
        c = L.apply_norm(p["cross_norm"], x, cfg.norm)
        x = x + _cross_attend(p["cross_attn"], cfg, c, cross["k"][li],
                              cross["v"][li], cache["enc_pos"])
        m = L.apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + L.apply_mlp(p["mlp"], cfg, m)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.lm_logits(params["embed"], cfg, x)[:, 0, :], cache
