"""Transformer building blocks of the LM: norms, RoPE, GQA attention (with
qk-norm and the local-window ring cache), MLP, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters
are plain dictionaries of tensors with the JAX package's names and layouts
(``wq`` (d, heads, hd), ``wo`` (heads, hd, d), ...), drawn from an explicit
``torch.Generator`` on its device with the JAX package's distributions.
The projections and the vocabulary head are plain ``torch.matmul``, as
JAX leaves them to XLA; the attention is the flash kernel K6 on CUDA
tensors and its plain version on CPU tensors
(``repro_torch.kernels.flash.kernel.attention``; its backward is K7), with
and without the KV cache.  Cache writes happen in place.
:func:`attention_xla` is the reference's plain masked attention in torch
(C9's rule: a query that sees no key gets the mean of v); the tests hold
the kernels' path against it, and no path of the port calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash.kernel import attention
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def draw_device(gen: torch.Generator, device=None) -> torch.device:
    """Where the initializers put what they draw from ``gen``: ``device``,
    or ``gen.device`` when it is None.  ``torch.device("meta")`` with a
    CPU generator gives shapes and dtypes only (``launch/shapes.py``); a
    meta generator does not exist."""
    return gen.device if device is None else torch.device(device)


def _normal(gen: torch.Generator, shape, dtype, device=None) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=draw_device(gen, device))


def _dense_init(gen: torch.Generator, shape, dtype, in_axis_size: int,
                device=None) -> Tensor:
    """normal · fan_in^−½, the product taken in ``dtype`` (as JAX's), in
    place: a stacked expert weight is allocated once."""
    dev = draw_device(gen, device)
    scale = torch.tensor(in_axis_size ** -0.5, dtype=dtype, device=dev)
    return _normal(gen, shape, dtype, dev).mul_(scale)


def make_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               lead: Tuple[int, ...] = (), device=None) -> Tensor:
    """A (d_in, d_out) weight (with ``lead`` stacking axes), normal ·
    d_in^−½; the reference's sharding axes have no counterpart here."""
    return _dense_init(gen, lead + (d_in, d_out), dtype, d_in, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg: ModelConfig, dtype,
              lead: Tuple[int, ...] = (), device=None) -> Params:
    dev = draw_device(gen, device)
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=dev)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=dev)
    return p


def apply_norm(p: Params, x: Tensor, kind: str, eps: float = 1e-6) -> Tensor:
    """Statistics in float32, products in x's dtype."""
    if kind == "rmsnorm":
        ms = x.float().square().mean(-1, keepdim=True)
        inv = torch.rsqrt(ms + eps).to(x.dtype)
        out = x * inv * p["scale"]
    else:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        inv = torch.rsqrt(var + eps)
        out = (x - mu.to(x.dtype)) * inv.to(x.dtype) * p["scale"]
    if "bias" in p:
        out = out + p["bias"]
    return out


# ---------------------------------------------------------------------------
# rotary embeddings (full or partial / "2d" fraction)
# ---------------------------------------------------------------------------

RopeTables = Tuple[int, Optional[Tensor], Optional[Tensor]]


def rope_tables(positions: Tensor, head_dim: int, theta: float,
                fraction: float) -> RopeTables:
    """(rotated width, cos, sin) for positions (B, S); cos/sin are
    (B, S, 1, rot/2) float32.  Shared by every layer of a step."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if rot == 0:
        return 0, None, None
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[:, :, None, None] * freqs
    return rot, torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, tables: RopeTables) -> Tensor:
    """x: (B, S, H, hd) rotated by precomputed :func:`rope_tables`."""
    rot, cos, sin = tables
    if rot == 0:
        return x
    half = rot // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    if rot == x.shape[-1]:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), x[..., rot:]], -1)


def rope(x: Tensor, positions: Tensor, theta: float, fraction: float
         ) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta,
                                     fraction))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   lead: Tuple[int, ...] = (), device=None) -> Params:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = draw_device(gen, device)
    p = {
        "wq": _dense_init(gen, lead + (d, nh, hd), dtype, d, dev),
        "wk": _dense_init(gen, lead + (d, nkv, hd), dtype, d, dev),
        "wv": _dense_init(gen, lead + (d, nkv, hd), dtype, d, dev),
        "wo": _dense_init(gen, lead + (nh, hd, d), dtype, nh * hd, dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
    return p


def _qk_normalize(x: Tensor, scale: Tensor) -> Tensor:
    """RMS-normalize each head's vector: statistics and scale in float32,
    eps 1e-6, cast back to x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
    return (xf * scale.float()).to(x.dtype)


def _project(x: Tensor, w: Tensor) -> Tensor:
    """(B, S, d) @ (d, heads, hd) → (B, S, heads, hd), one matmul."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def apply_attention(p: Params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                    *, window: int = 0, cache: Optional[Params] = None,
                    cache_index: Optional[Tensor] = None,
                    tables: Optional[RopeTables] = None,
                    causal: bool = True
                    ) -> Tuple[Tensor, Optional[Params]]:
    """Attention sublayer, causal unless ``causal`` is False (whisper's
    encoder).  x: (B, S, D); positions: (B, S) int32; ``window``: local
    attention over the last ``window`` positions (0 = none).  With
    ``cfg.qk_norm``, q and k are RMS-normalized per head before rope.

    Without ``cache``: prefill / teacher-forced self-attention.  With
    ``cache`` (``k``/``v`` (B, L, KH, hd), ``pos`` (B, L)): write this
    step's K/V at ``cache_index`` in place and attend over the cache.  A
    0-dim ``cache_index`` writes every row at that slot; a (B,) one writes
    row b at its own slot (S must be 1), and a row with index < 0 is idle:
    it writes into the trash slot L−1 with position −1, which no query
    sees.  With a window the cache is a ring (``init_attn_cache(window=)``)
    and index i writes slot i mod L; ``pos`` keeps the masking exact
    across wraparound.  ``tables``: this step's rope tables (computed here
    if None).
    """
    b, s, _ = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    if tables is None:
        tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                             cfg.rope_fraction)
    q = apply_rope(q, tables).contiguous()
    k = apply_rope(k, tables).contiguous()
    v = v.contiguous()

    if cache is None:
        out = attention(q, k, v, positions, positions, causal=causal,
                        window=window)
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        length = ck.shape[1]
        idx = cache_index
        if not torch.is_tensor(idx) or idx.ndim == 0:
            # uniform write index, clamped as lax.dynamic_update_slice does
            slot = int(idx) % length if window else int(idx)
            slot = min(max(slot, 0), length - s)
            ck[:, slot:slot + s] = k.to(ck.dtype)
            cv[:, slot:slot + s] = v.to(cv.dtype)
            cpos[:, slot:slot + s] = positions
        else:
            if s != 1:
                raise ValueError("a per-row cache_index needs single-token "
                                 "steps")
            slot = torch.where(idx >= 0, idx % length if window else idx,
                               length - 1)
            rows = torch.arange(b, device=x.device)
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            cpos[rows, slot] = positions[:, 0]
        out = attention(q, ck, cv, positions, cpos, causal=causal,
                        window=window)
        out = _idle_rows_mean_v(out, cv, positions)
        cache = {"k": ck, "v": cv, "pos": cpos}

    wo = p["wo"]
    y = out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, cache


def _attend_block(qg: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """qg (B, Sq, KH, G, hd), k/v (B, Sk, KH, hd), mask (B, 1, 1, Sq, Sk):
    float32 scores, masked at −1e30, softmax, P cast to v's dtype for P·V
    (the reference's ``_attend_block``)."""
    hd = qg.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    p = torch.softmax(torch.where(mask, s, -1e30), -1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def attention_xla(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  window: int, q_pos: Tensor, kv_pos: Tensor,
                  chunk: int = 0) -> Tensor:
    """The reference's plain attention (``repro/models/layers.py:147``):
    q (B, Sq, NH, hd), k/v (B, Sk, KH, hd), masking by position (kv
    positions −1 are invalid; causal; ``window`` 0 = none).  A query with
    no visible key gets a uniform softmax, the mean of v (C9).  ``chunk``:
    query-block size (0 or ≥ Sq, or not dividing Sq: one block); the
    blocks compute the same."""
    b, sq, nh, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, nh // kh, hd)
    ik = kv_pos[:, None, None, None, :]

    def mask_for(iq_abs: Tensor) -> Tensor:
        iq = iq_abs[:, None, None, :, None]
        m = ik >= 0
        if causal:
            m = m & (ik <= iq)
        if window:
            m = m & (ik > iq - window)
        return m

    if chunk <= 0 or chunk >= sq or sq % chunk:
        out = _attend_block(qg, k, v, mask_for(q_pos))
    else:
        out = torch.cat([_attend_block(qg[:, i:i + chunk], k, v,
                                       mask_for(q_pos[:, i:i + chunk]))
                         for i in range(0, sq, chunk)], 1)
    return out.reshape(b, sq, nh, hd)


@dataclasses.dataclass(frozen=True)
class AttnTemps:
    """Static attention call profile (which path, masking, chunking), as
    the reference's."""
    causal: bool = True
    window: int = 0
    chunk: int = 1024


def _idle_rows_mean_v(out: Tensor, cv: Tensor, positions: Tensor) -> Tensor:
    """``attention_xla``'s rule for a query that sees no key (ROADMAP C9):
    a uniform softmax over the whole cache, i.e. the mean of v.  In a
    decode step those are exactly the idle rows (position −1; a live row
    sees its own key), so K6's 0 there is replaced.  An idle row's output
    reaches live rows through the MoE capacity it takes and, in the
    hybrid family, the recurrent states it advances (C17)."""
    nh, kh = out.shape[2], cv.shape[2]
    vmean = cv.mean(1, dtype=torch.float32).repeat_interleave(nh // kh, 1)
    return torch.where(positions[:, :, None, None] < 0,
                       vmean[:, None].to(out.dtype), out)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    lead: Tuple[int, ...] = (), device=None,
                    window: int = 0) -> Params:
    """Preallocated KV cache.  Local-attention layers bound it by
    ``window`` (a ring of min(max_len, window) slots); ``pos`` holds each
    slot's absolute position (−1 = empty)."""
    length = min(max_len, window) if window else max_len
    shape = lead + (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dev = draw_device(gen, device)
    p = {
        "w_up": _dense_init(gen, lead + (d, ff), dtype, d, dev),
        "w_down": _dense_init(gen, lead + (ff, d), dtype, ff, dev),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, lead + (d, ff), dtype, d, dev)
    return p


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def apply_mlp(p: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    h = x @ p["w_up"]
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        h = (F.silu(g) if cfg.activation == "swiglu" else _gelu(g)) * h
    else:
        h = _gelu(h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device=None) -> Params:
    dev = draw_device(gen, device)
    scale = torch.tensor(0.02, dtype=dtype, device=dev)
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), dtype, dev)
         * scale}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                cfg.d_model, dev)
    return p


def embed_tokens(p: Params, tokens: Tensor) -> Tensor:
    return p["tok"][tokens]


def lm_logits(p: Params, cfg: ModelConfig, x: Tensor) -> Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return x @ w
