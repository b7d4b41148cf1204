"""The decoder-only LM: init, forward, loss, and serving with a decode
cache.

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
when drawn here.  The same keys may instead hold the stacks themselves,
the reference's tree (``init_params(stacked=True)``, what training
holds: one leaf per reference leaf, so its gradient, moments and norm
go over the reference's leaves); every entry point then takes the
per-layer views itself, at each call (:func:`per_layer`), so autograd
sees them as fresh views of the leaves.  On CUDA tensors every attention
is the flash kernel K6 (its backward K7): ``forward`` launches it once
per attention layer with Sq = S, ``decode_step`` once per attention
layer per step over the whole cache (the ssm family has none).

``cfg.remat`` says what a layer unit keeps for its backward when a
gradient is taken (:func:`_remat`; the units are the reference's scan
bodies: a dense/moe/vlm block, a hybrid triple, a hybrid tail layer, an
ssm group): ``"none"`` everything autograd saves; ``"full"`` only the
unit's inputs, the unit run again in the backward
(``torch.utils.checkpoint``, so K6 runs twice a layer and K7 once);
``"dots"`` the outputs of its 2-D products as well (the twin of
``dots_with_no_batch_dims_saveable``), the rest, attention included,
run again.  All three give the same bits.  Without a gradient, and
whenever a cache is written, a unit runs once and saves nothing.

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

import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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

def _dense_block(gen, cfg: ModelConfig, dtype, n: int, dev
                 ) -> Dict[str, Any]:
    p = {
        "attn_norm": L.init_norm(gen, cfg, dtype, (n,), dev),
        "attn": L.init_attention(gen, cfg, dtype, (n,), dev),
        "mlp_norm": L.init_norm(gen, cfg, dtype, (n,), dev),
    }
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, (n,), dev)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, (n,), dev)
    return p


def _rg_block(gen, cfg: ModelConfig, dtype, kind: str, n: int, dev
              ) -> Dict[str, Any]:
    p = {
        "mix_norm": L.init_norm(gen, cfg, dtype, (n,), dev),
        "mlp_norm": L.init_norm(gen, cfg, dtype, (n,), dev),
        "mlp": L.init_mlp(gen, cfg, dtype, (n,), dev),
    }
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype, (n,), dev)
    else:
        p["rec"] = RG.init_recurrent_block(gen, cfg, dtype, (n,), dev)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stacked: bool = False, device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``device`` (default
    ``gen.device``; ``"meta"`` with a CPU generator gives the shapes
    alone), with the JAX package's distributions (dense weights normal ·
    fan_in^−½; the router, ``lambda_param``, ``w_if`` and ``r_*``
    float32; token embedding normal · 0.02; norm scales ones).  Per-layer
    views, or with ``stacked`` the stacks themselves (the reference's
    tree; the same draws)."""
    _require_served(cfg)
    dtype, dev = torch_dtype(cfg), L.draw_device(gen, device)
    if cfg.family == "ssm":
        n_groups, n_m = ssm_layout(cfg)
        params = {"groups": {
            "mlstm": XL.init_mlstm_block(gen, cfg, dtype, (n_groups, n_m),
                                         dev),
            "slstm": XL.init_slstm_block(gen, cfg, dtype, (n_groups,),
                                         dev)}}
    elif cfg.family == "hybrid":
        n_triples, n_tail = hybrid_layout(cfg)
        params = {"triples": {
            kind: _rg_block(gen, cfg, dtype,
                            "attn" if kind == "attn" else "rec", n_triples,
                            dev)
            for kind in ("rec1", "rec2", "attn")}}
        if n_tail:
            params["tail"] = _rg_block(gen, cfg, dtype, "rec", n_tail, dev)
    else:
        params = {"blocks": _dense_block(gen, cfg, dtype, cfg.n_layers, dev)}
    tree = {"embed": L.init_embedding(gen, cfg, dtype, dev),
            "final_norm": L.init_norm(gen, cfg, dtype, device=dev), **params}
    return tree if stacked else per_layer(tree)


def unstack_layers(stacked) -> List[Any]:
    """A nested dictionary of (n, ...) tensors → n nested dictionaries of
    views, one a layer, each leaf split by one ``unbind`` (under autograd
    one backward node a leaf, which stacks the layers' gradients once)."""
    if isinstance(stacked, dict):
        parts = {k: unstack_layers(v) for k, v in stacked.items()}
        count = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(count)]
    return list(stacked.unbind(0))


STACKS = ("blocks", "triples", "tail", "enc", "dec")


def per_layer(params: Dict[str, Any], keys=STACKS) -> Dict[str, Any]:
    """The per-layer form of a parameter tree: each stacked layer entry
    named in ``keys`` (``blocks``, ``triples``, ``tail``, whisper's
    ``enc``/``dec``; and ``groups``, with each group's ``mlstm``) split
    into per-layer views; entries already split are kept as they are."""
    out = dict(params)
    for key in keys:
        if isinstance(out.get(key), dict):
            out[key] = unstack_layers(out[key])
    if isinstance(out.get("groups"), dict):
        out["groups"] = [dict(g, mlstm=unstack_layers(g["mlstm"]))
                         for g in unstack_layers(out["groups"])]
    return out


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
# remat
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "dots")
# the 2-D products "dots" keeps: every projection and the vocabulary head
# (``x @ w`` of a (B, S, d) x folds to one ``mm``); batched products
# (attention's, the experts' ``bmm``, the mLSTM's) are recomputed, as
# dots_with_no_batch_dims_saveable recomputes dots with batch dims
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` (a layer unit) as ``cfg.remat`` says, when a gradient is
    being taken: ``torch.utils.checkpoint`` (non-reentrant, which works
    with ``torch.autograd.grad``), under "dots" with a policy that keeps
    the 2-D products' outputs; ``fn`` itself under "none" or without
    grad mode.  Callers never wrap a unit that writes a cache: its
    recompute would write the slots again."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"remat {cfg.remat!r} not in {REMAT_MODES}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _keep_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


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


def _ssm_group(grp, cfg: ModelConfig, x: Tensor) -> Tensor:
    """One xLSTM group without a cache (the remat unit)."""
    for p in grp["mlstm"]:
        x = x + XL.apply_mlstm_block(p, cfg, x)[0]
    return x + XL.apply_slstm_block(grp["slstm"], cfg, x)[0]


def _run_ssm(params, cfg: ModelConfig, x: Tensor, cache=None) -> Tensor:
    """xLSTM groups in order, each block's output added to the residual
    (no pre-norm, as in the reference).  With ``cache``: one decode step,
    each block's new state written into the cache in place."""
    if cache is None:
        unit = _remat(_ssm_group, cfg)
        for grp in params["groups"]:
            x = unit(grp, cfg, x)
        return x
    groups = cache["groups"]
    for g, grp in enumerate(params["groups"]):
        for i, p in enumerate(grp["mlstm"]):
            st = _layer(groups["mlstm"], (g, i))
            y, new = XL.apply_mlstm_block(p, cfg, x, st, decode=True)
            _write(st, new)
            x = x + y
        st = _layer(groups["slstm"], g)
        y, new = XL.apply_slstm_block(grp["slstm"], cfg, x, st)
        _write(st, new)
        x = x + y
    return x


def _triple(tri, cfg: ModelConfig, x: Tensor, positions: Tensor, tables
            ) -> Tensor:
    """One hybrid (rec, rec, attn) triple without a cache (a remat
    unit)."""
    for kind in ("rec1", "rec2", "attn"):
        x = _rg_apply(tri[kind], cfg, x, positions, tables)
    return x


def _run_layers(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                cache=None, cache_index=None) -> Tuple[Tensor, Tensor]:
    """Every layer in order; → (x, summed aux loss)."""
    params = per_layer(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return _run_ssm(params, cfg, x, cache), aux
    tables = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    if cfg.family == "hybrid":
        if cache is None:
            triple, tail = _remat(_triple, cfg), _remat(_rg_apply, cfg)
            for tri in params["triples"]:
                x = triple(tri, cfg, x, positions, tables)
            for p in params.get("tail", ()):
                x = tail(p, cfg, x, positions, tables)
            return x, aux
        for i, tri in enumerate(params["triples"]):
            c = _layer(cache["triples"], i)
            for kind in ("rec1", "rec2", "attn"):
                x = _rg_apply(tri[kind], cfg, x, positions, tables, c[kind],
                              cache_index)
        for i, p in enumerate(params.get("tail", ())):
            x = _rg_apply(p, cfg, x, positions, tables,
                          _layer(cache["tail"], i))
        return x, aux
    block = _block if cache is not None else _remat(_block, cfg)
    for i, p in enumerate(params["blocks"]):
        c = None if cache is None else _layer(cache, i)
        x, a = block(p, cfg, x, positions, tables, c, cache_index)
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
# loss
# ---------------------------------------------------------------------------

def cross_entropy(params, cfg: ModelConfig, hidden: Tensor,
                  targets: Tensor) -> Tensor:
    """Mean softmax cross-entropy of the vocabulary head on ``hidden``
    (B, S, D) against ``targets`` (B, S): float32 logits, a log-sum-exp
    shifted by the row's max (detached, as the reference's
    ``stop_gradient``), minus the target's logit.  The target's logit is a
    ``gather``, which equals the reference's one-hot sum exactly (every
    other term is 0·logit = 0) and saves a (B, S, V) float32 tensor."""
    logits = L.lm_logits(params["embed"], cfg, hidden).float()
    lmax = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - lmax).sum(-1)) + lmax[..., 0]
    true_logit = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - true_logit).mean()


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, Tensor]) -> Tensor:
    """The training loss: cross-entropy of ``forward`` on ``batch``
    (``tokens``, ``targets``, optional stub ``embeddings``) plus 0.01 × the
    MoE auxiliary loss."""
    hidden, aux = forward(params, cfg, batch["tokens"],
                          embeddings=batch.get("embeddings"))
    return cross_entropy(params, cfg, hidden, batch["targets"]) + 0.01 * aux


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
    # a Python int stays one as the write index: its slot is read on the
    # host, with no device read (and a meta cache, which holds no values,
    # takes it too)
    index = position if isinstance(position, int) else pos
    x, _ = _run_layers(params, cfg, x, positions.contiguous(), cache, index)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.lm_logits(params["embed"], cfg, x)[:, 0, :], cache
