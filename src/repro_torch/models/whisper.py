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
layer of views of one stacked tensor per weight when drawn here, or the
stacks themselves (``init_params(stacked=True)``, the reference's tree,
what training holds; ``lm.per_layer`` splits them at each call).
:func:`lm_loss` is the training loss (encode, decode_train, the LM's
cross-entropy); under autograd every K6 call's backward is K7.  When a
gradient is taken and ``cfg.remat`` is not "none", each encoder and
decoder layer body runs under ``torch.utils.checkpoint`` ("dots" is plain
checkpointing here, as in the reference), so its K6 calls run again in
the backward.  The encoder-decoder does not run on a mesh yet: with an
ambient one each entry point raises (ROADMAP queue A item 9b, whose
item 2 ports the ssm, encdec and moe families to the mesh after the
dense and hybrid ones).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import require_no_mesh
from repro_torch.kernels.flash.kernel import attention
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _remat as lm_remat
from repro_torch.models.lm import cross_entropy, per_layer, torch_dtype

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


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stacked: bool = False, device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``device`` (default
    ``gen.device``; "meta" gives shapes alone) with the JAX package's
    distributions (see ``lm.init_params``); per-layer views, or with
    ``stacked`` the stacks themselves."""
    dtype, dev = torch_dtype(cfg), L.draw_device(gen, device)
    ne, nd = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    enc = {
        "attn_norm": L.init_norm(gen, cfg, dtype, ne, dev),
        "attn": L.init_attention(gen, cfg, dtype, ne, dev),
        "mlp_norm": L.init_norm(gen, cfg, dtype, ne, dev),
        "mlp": L.init_mlp(gen, cfg, dtype, ne, dev),
    }
    dec = {
        "self_norm": L.init_norm(gen, cfg, dtype, nd, dev),
        "self_attn": L.init_attention(gen, cfg, dtype, nd, dev),
        "cross_norm": L.init_norm(gen, cfg, dtype, nd, dev),
        "cross_attn": L.init_attention(gen, cfg, dtype, nd, dev),
        "mlp_norm": L.init_norm(gen, cfg, dtype, nd, dev),
        "mlp": L.init_mlp(gen, cfg, dtype, nd, dev),
    }
    tree = {
        "embed": L.init_embedding(gen, cfg, dtype, dev),
        "enc": enc,
        "dec": dec,
        "enc_norm": L.init_norm(gen, cfg, dtype, device=dev),
        "final_norm": L.init_norm(gen, cfg, dtype, device=dev),
    }
    return tree if stacked else per_layer(tree)


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


def _remat(fn, cfg: ModelConfig):
    """``fn`` (a layer body) as ``lm._remat`` wraps it, "dots" taken as
    "full": plain checkpointing, as in the reference."""
    return lm_remat(fn, cfg.replace(remat="full") if cfg.remat == "dots"
                    else cfg)


def _enc_layer(p, cfg: ModelConfig, x: Tensor, pos: Tensor) -> Tensor:
    a = L.apply_norm(p["attn_norm"], x, cfg.norm)
    a, _ = L.apply_attention(p["attn"], cfg, a, pos, causal=False)
    x = x + a
    m = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], cfg, m)


def encode(params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder hidden states."""
    require_no_mesh("the encoder-decoder")
    b, s, d = frames.shape
    dt = torch_dtype(cfg)
    pos = _positions(b, s, frames.device)
    x = frames.to(dt) + _sinusoidal(pos, d, dt)
    layer = _remat(_enc_layer, cfg)
    for p in per_layer(params, ("enc",))["enc"]:
        x = layer(p, cfg, x, pos)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def _dec_layer(p, cfg: ModelConfig, x: Tensor, pos: Tensor,
               enc_out: Tensor, enc_pos: Tensor) -> Tensor:
    a = L.apply_norm(p["self_norm"], x, cfg.norm)
    a, _ = L.apply_attention(p["self_attn"], cfg, a, pos, causal=True)
    x = x + a
    c = L.apply_norm(p["cross_norm"], x, cfg.norm)
    ek, ev = _enc_kv(p["cross_attn"], enc_out)
    x = x + _cross_attend(p["cross_attn"], cfg, c, ek, ev, enc_pos)
    m = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], cfg, m)


def decode_train(params, cfg: ModelConfig, enc_out: Tensor,
                 tokens: Tensor) -> Tensor:
    """Teacher-forced decoder pass → final hidden (B, S_dec, D)."""
    require_no_mesh("the encoder-decoder")
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    enc_pos = _positions(b, enc_out.shape[1], enc_out.device)
    layer = _remat(_dec_layer, cfg)
    for p in per_layer(params, ("dec",))["dec"]:
        x = layer(p, cfg, x, pos, enc_out, enc_pos)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    """The training loss: ``encode`` the batch's ``frames``, ``decode_train``
    its ``tokens``, and the LM's cross-entropy against its ``targets``."""
    enc_out = encode(params, cfg, batch["frames"])
    hidden = decode_train(params, cfg, enc_out, batch["tokens"])
    return cross_entropy(params, cfg, hidden, batch["targets"])


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
    require_no_mesh("the encoder-decoder")
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
    kv = [_enc_kv(p["cross_attn"], enc_out)
          for p in per_layer(params, ("dec",))["dec"]]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache,
                position: int) -> Tuple[Tensor, Any]:
    """One decoder step, every row at the same ``position``.  tokens:
    (B, 1) → (logits (B, V), the same cache, written in place)."""
    require_no_mesh("the encoder-decoder")
    b = tokens.shape[0]
    pos = torch.full((b, 1), int(position), dtype=torch.int32,
                     device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    sc, cross = cache["self"], cache["cross"]
    for li, p in enumerate(per_layer(params, ("dec",))["dec"]):
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
