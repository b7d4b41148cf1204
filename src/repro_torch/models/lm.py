"""The decoder-only LM: init, forward, and serving with a decode cache.

Counterpart of ``repro/models/lm.py`` (dense, moe, vlm, hybrid and ssm
families; the encoder-decoder lives in ``models/whisper.py``).
Parameters are a dictionary ``{"embed", "final_norm", ...}`` holding,
for dense/moe/vlm, ``blocks``: one dictionary per layer, with ``moe`` in
place of ``mlp`` when the config has experts; for hybrid
(RecurrentGemma), ``triples``: one ``{"rec1", "rec2", "attn"}``
dictionary per (recurrent, recurrent, attention) triple, and ``tail``:
the recurrent layers after the last triple; for ssm (xLSTM), ``groups``:
one ``{"mlstm": [slstm_every − 1 layers], "slstm"}`` dictionary per
group.  Each layer's tensors are views of one stacked tensor per weight
when drawn here.  On CUDA tensors every attention is the flash kernel K6:
``forward`` launches it once per attention layer with Sq = S,
``decode_step`` once per attention layer per step over the whole cache
(the ssm family has none).

The decode cache is preallocated on the device with the reference's
nesting and a leading layer axis, ``k``/``v`` (L, B, Lmax, KH, hd) and
``pos`` (L, B, Lmax) for dense/moe/vlm; for hybrid, ``triples`` holds
``rec1``/``rec2`` recurrent states (``conv`` (T, B, K−1, W), ``h`` (T, B,
W) float32) and ``attn``, a ring of min(max_len, window) slots, and
``tail`` the tail's recurrent states; for ssm, ``groups`` holds ``mlstm``
= (conv (G, M, B, K−1, up), (C (G, M, B, H, dk, dv), n, m)) and ``slstm``
= (c, n, h, m) (G, B, d), the cell states float32.  Every step writes
into it in place (JAX threads it through a scan carry that XLA aliases).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Tree = Union[Dict[str, Any], List[Any], Tensor]


def _require_served(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm"):
        raise ValueError(
            f"{cfg.name}: family {cfg.family} not handled here; the "
            f"encoder-decoder lives in models/whisper.py")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(triples, tail layers) of a hybrid config: n_layers // attn_every
    (rec, rec, attn) triples, then the recurrent rest."""
    n_triples = cfg.n_layers // cfg.attn_every
    return n_triples, cfg.n_layers - n_triples * cfg.attn_every


def ssm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mLSTM layers a group) of an ssm config: n_layers //
    slstm_every groups of slstm_every − 1 mLSTM layers and one sLSTM."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def attention_layers(cfg: ModelConfig) -> int:
    """Attention layers, i.e. K6 launches a decode step on the card."""
    if cfg.family == "hybrid":
        return hybrid_layout(cfg)[0]
    return 0 if cfg.family == "ssm" else cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_block(gen, cfg: ModelConfig, dtype, n: int) -> Dict[str, Any]:
    p = {
        "attn_norm": L.init_norm(gen, cfg, dtype, (n,)),
        "attn": L.init_attention(gen, cfg, dtype, (n,)),
        "mlp_norm": L.init_norm(gen, cfg, dtype, (n,)),
    }
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, (n,))
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, (n,))
    return p


def _rg_block(gen, cfg: ModelConfig, dtype, kind: str, n: int
              ) -> Dict[str, Any]:
    p = {
        "mix_norm": L.init_norm(gen, cfg, dtype, (n,)),
        "mlp_norm": L.init_norm(gen, cfg, dtype, (n,)),
        "mlp": L.init_mlp(gen, cfg, dtype, (n,)),
    }
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype, (n,))
    else:
        p["rec"] = RG.init_recurrent_block(gen, cfg, dtype, (n,))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``gen.device``, with the JAX
    package's distributions (dense weights normal · fan_in^−½; the router,
    ``lambda_param``, ``w_if`` and ``r_*`` float32; token embedding normal
    · 0.02; norm scales ones)."""
    _require_served(cfg)
    dtype = torch_dtype(cfg)
    if cfg.family == "ssm":
        n_groups, n_m = ssm_layout(cfg)
        mlstm = XL.init_mlstm_block(gen, cfg, dtype, (n_groups, n_m))
        slstm = XL.init_slstm_block(gen, cfg, dtype, (n_groups,))
        params = {"groups": [
            {"mlstm": unstack_layers(_layer(mlstm, g), n_m),
             "slstm": _layer(slstm, g)} for g in range(n_groups)]}
    elif cfg.family == "hybrid":
        n_triples, n_tail = hybrid_layout(cfg)
        triples = {kind: _rg_block(gen, cfg, dtype,
                                   "attn" if kind == "attn" else "rec",
                                   n_triples)
                   for kind in ("rec1", "rec2", "attn")}
        tail = _rg_block(gen, cfg, dtype, "rec", n_tail) if n_tail else None
        params = {"triples": unstack_layers(triples, n_triples)}
        if tail is not None:
            params["tail"] = unstack_layers(tail, n_tail)
    else:
        params = {"blocks": unstack_layers(
            _dense_block(gen, cfg, dtype, cfg.n_layers), cfg.n_layers)}
    return {"embed": L.init_embedding(gen, cfg, dtype),
            "final_norm": L.init_norm(gen, cfg, dtype), **params}


def unstack_layers(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """A nested dictionary of (n, ...) tensors → n nested dictionaries of
    views, one a layer."""
    return [_layer(stacked, i) for i in range(n)]


def tensors(tree: Tree) -> Iterator[Tensor]:
    """Every tensor of a nested dictionary / list (parameters, caches)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    else:
        yield tree


def param_bytes(params: Tree) -> int:
    """Bytes of every distinct parameter storage."""
    seen, total = set(), 0
    for t in tensors(params):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def param_numel(params: Tree) -> int:
    """Parameters (elements) of every distinct stacked storage, whatever
    their dtype."""
    seen, total = set(), 0
    for t in tensors(params):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes() // t.element_size()
    return total


def cache_bytes(cache: Tree) -> int:
    """Bytes of a decode cache, every nested leaf."""
    return sum(t.numel() * t.element_size() for t in tensors(cache))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block(p, cfg: ModelConfig, x: Tensor, positions: Tensor, tables,
           cache=None, cache_index=None):
    """Dense / moe / vlm block → (x, aux loss or None)."""
    h = L.apply_norm(p["attn_norm"], x, cfg.norm)
    a, _ = L.apply_attention(p["attn"], cfg, h, positions, cache=cache,
                             cache_index=cache_index, tables=tables)
    x = x + a
    h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    if cfg.is_moe:
        m, aux = MOE.apply_moe(p["moe"], cfg, h)
        return x + m, aux
    return x + L.apply_mlp(p["mlp"], cfg, h), None


def _rg_apply(p, cfg: ModelConfig, x: Tensor, positions: Tensor, tables,
              state=None, cache_index=None):
    """RecurrentGemma block (``attn`` or ``rec`` mixer).  A recurrent
    ``state`` is advanced in place; an attention ``state`` is the layer's
    ring cache, written in place."""
    h = L.apply_norm(p["mix_norm"], x, cfg.norm)
    if "attn" in p:
        a, _ = L.apply_attention(p["attn"], cfg, h, positions,
                                 window=cfg.window, cache=state,
                                 cache_index=cache_index, tables=tables)
    else:
        a, new = RG.apply_recurrent_block(p["rec"], cfg, h, state)
        if state is not None:
            state["conv"].copy_(new["conv"])
            state["h"].copy_(new["h"])
    x = x + a
    h = L.apply_norm(p["mlp_norm"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], cfg, h)


def _layer(tree, i):
    """Layer ``i``'s views (``leaf[i]``; ``i`` may be a tuple of indices)
    of a stacked nest of dictionaries and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def _write(dst, src) -> None:
    """Copy a new state into the cache's views, leaf for leaf."""
    if isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _write(d, s_)
    else:
        dst.copy_(src)


def _run_ssm(params, cfg: ModelConfig, x: Tensor, cache=None) -> Tensor:
    """xLSTM groups in order, each block's output added to the residual
    (no pre-norm, as in the reference).  With ``cache``: one decode step,
    each block's new state written into the cache in place."""
    groups = None if cache is None else cache["groups"]
    for g, grp in enumerate(params["groups"]):
        for i, p in enumerate(grp["mlstm"]):
            st = None if groups is None else _layer(groups["mlstm"],
                                                    (g, i))
            y, new = XL.apply_mlstm_block(p, cfg, x, st,
                                          decode=st is not None)
            if st is not None:
                _write(st, new)
            x = x + y
        st = None if groups is None else _layer(groups["slstm"], g)
        y, new = XL.apply_slstm_block(grp["slstm"], cfg, x, st)
        if st is not None:
            _write(st, new)
        x = x + y
    return x


def _run_layers(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                cache=None, cache_index=None) -> Tuple[Tensor, Tensor]:
    """Every layer in order; → (x, summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return _run_ssm(params, cfg, x, cache), aux
    tables = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    if cfg.family == "hybrid":
        tri_c = None if cache is None else cache["triples"]
        for i, tri in enumerate(params["triples"]):
            c = None if tri_c is None else _layer(tri_c, i)
            for kind in ("rec1", "rec2", "attn"):
                x = _rg_apply(tri[kind], cfg, x, positions, tables,
                              None if c is None else c[kind], cache_index)
        for i, p in enumerate(params.get("tail", ())):
            c = None if cache is None else _layer(cache["tail"], i)
            x = _rg_apply(p, cfg, x, positions, tables, c)
        return x, aux
    for i, p in enumerate(params["blocks"]):
        c = None if cache is None else _layer(cache, i)
        x, a = _block(p, cfg, x, positions, tables, c, cache_index)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# forward (no cache)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens: Optional[Tensor],
            embeddings: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Teacher-forced inference: tokens (B, S) → (final hidden (B, S, D),
    MoE aux loss summed over layers, 0 without experts).  ``embeddings``
    (B, S, D) replaces the token lookup (stub frontends).  On CUDA each
    attention layer is one K6 launch."""
    _require_served(cfg)
    x = L.embed_tokens(params["embed"], tokens) if embeddings is None \
        else embeddings
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s).contiguous()
    x, aux = _run_layers(params, cfg, x, positions)
    return L.apply_norm(params["final_norm"], x, cfg.norm), aux


# ---------------------------------------------------------------------------
# serving: decode with a preallocated cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None
               ) -> Dict[str, Any]:
    """Stacked per-layer decode state, all slots empty (position −1,
    recurrent states as the reference's init: 0, but the mLSTM ``m``
    −1e30 and the sLSTM ``n`` 1), on ``device``: ``None`` means the card,
    as at every entry point (``repro_torch.resolve_device``), so pass
    ``device="cpu"`` on the CPU."""
    _require_served(cfg)
    dtype, dev = torch_dtype(cfg), resolve_device(device)
    if cfg.family == "ssm":
        n_groups, n_m = ssm_layout(cfg)
        return {"groups": {
            "mlstm": XL.init_mlstm_state(cfg, batch, dtype, (n_groups, n_m),
                                         dev),
            "slstm": XL.init_slstm_state(cfg, batch, (n_groups,), dev)}}
    if cfg.family != "hybrid":
        return L.init_attn_cache(cfg, batch, max_len, dtype,
                                 lead=(cfg.n_layers,), device=dev)
    n_triples, n_tail = hybrid_layout(cfg)
    out = {"triples": {
        "rec1": RG.init_recurrent_state(cfg, batch, dtype, (n_triples,), dev),
        "rec2": RG.init_recurrent_state(cfg, batch, dtype, (n_triples,), dev),
        "attn": L.init_attn_cache(cfg, batch, max_len, dtype,
                                  lead=(n_triples,), device=dev,
                                  window=cfg.window)}}
    if n_tail:
        out["tail"] = RG.init_recurrent_state(cfg, batch, dtype, (n_tail,),
                                              dev)
    return out


def reset_slot(cfg: ModelConfig, cache: Dict[str, Any], slot: int
               ) -> Dict[str, Any]:
    """Empty one batch slot in place (continuous-batching admission): its
    attention positions become −1, so the previous occupant's entries can
    never pass the position mask, and every other leaf (K/V, recurrent
    states) becomes 0, as in the reference: so a reset ssm slot is not a
    fresh one, whose mLSTM ``m`` is −1e30 and sLSTM ``n`` ones (ROADMAP
    C18).  The batch axis is 2 of the doubly stacked ``mlstm`` leaves and
    1 of every other leaf."""
    def fix(node, axis, key):
        if isinstance(node, dict):
            for k, v in node.items():
                fix(v, 2 if k == "mlstm" else axis, k)
        elif isinstance(node, tuple):
            for v in node:
                fix(v, axis, None)
        else:
            node[(slice(None),) * axis + (slot,)] = -1 if key == "pos" else 0
    fix(cache, 1, None)
    return cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor,
                cache: Dict[str, Any], position: Union[int, Tensor]
                ) -> Tuple[Tensor, Dict[str, Any]]:
    """One serving step.  tokens (B, 1); position: () or (B,) int32, each
    row's index of this token (the vector form is continuous batching; a
    row at −1 is idle: its attention writes go to the trash slot, and its
    recurrent states advance on its token as in the reference).  Writes
    the cache in place and returns (logits (B, V), the same cache)."""
    _require_served(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    b = x.shape[0]
    pos = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    positions = (pos.expand(b, 1) if pos.ndim == 0 else pos[:, None])
    x, _ = _run_layers(params, cfg, x, positions.contiguous(), cache, pos)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.lm_logits(params["embed"], cfg, x)[:, 0, :], cache
