"""Plain PyTorch versions of the flash-attention kernels K6 and K7, and of
K8/K9, the split decode attention of a head-dim-sharded cache.

The CPU path of the kernel wrappers, and what ``chip_smoke.py`` holds the
kernels against on the card.  Masking is by position, as on the serving
path (``repro/models/layers.py::attention_xla``): key j of row b is seen
by query i when ``kv_pos[b, j] >= 0`` and, if causal,
``kv_pos[b, j] <= q_pos[b, i]`` and, with a window w (not None, any
sign: the Pallas kernel's rule), ``kv_pos[b, j] > q_pos[b, i] - w``.  A query with no such key gets 0, as
in the Pallas kernel (``repro/kernels/flash/kernel.py:75-78``; the XLA
path would give the mean of v).  Scores, softmax and P·V are float32; the
output is in q's dtype.  The backward (K7's plain version) takes the
forward's log-sum-exp and the same masking: with P = exp(S·scale − lse) on
visible entries, D = rowsum(dO∘O) and dS = P∘(dO·Vᵀ − D), it returns
dQ = scale·dS·K, dK = scale·dSᵀ·Q and dV = Pᵀ·dO, in float32 and cast to
the inputs' dtypes.

K8 (:func:`flash_decode_scores_ref`) is one rank's partial scores of a
decode step, q·kᵀ over its slice of the head dim, unscaled and unmasked;
K9 (:func:`flash_decode_pv_ref`) takes the scores summed over the ranks
and this rank's slice of V: the masked float32 softmax of scale·s (the
whole head dim's scale) times V, 0 for a row with no visible key.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def position_mask(q_pos: Tensor, kv_pos: Tensor, causal: bool,
                  window: Optional[int]) -> Tensor:
    """(B, Sq, Sk) bool: which keys each query sees."""
    iq = q_pos[:, :, None]
    ik = kv_pos[:, None, :]
    mask = (ik >= 0).expand(-1, iq.shape[1], -1)
    if causal:
        mask = mask & (ik <= iq)
    if window is not None:
        mask = mask & (ik > iq - window)
    return mask


def flash_attention_fwd_ref(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                            kv_pos: Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            return_lse: bool = False):
    """q (B, Sq, NH, hd), k/v (B, Sk, KH, hd), q_pos (B, Sq), kv_pos (B, Sk)
    → (B, Sq, NH, hd).  Query head h reads KV head h // (NH // KH); the KV
    heads are never repeated.  With ``return_lse``, also each row's
    log-sum-exp of its scaled visible scores, (B, NH, Sq) float32, +inf
    for a row with no visible key."""
    b, sq, nh, hd = q.shape
    kh = k.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    qg = q.float().reshape(b, sq, kh, nh // kh, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, nh, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, torch.inf, m + torch.log(l))
    return o, lse.reshape(b, nh, sq)


def flash_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                            lse: Tensor, dout: Tensor, q_pos: Tensor,
                            kv_pos: Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """(dQ, dK, dV) of :func:`flash_attention_fwd_ref` at q, k, v, given its
    output ``o``, its log-sum-exp ``lse`` (B, NH, Sq) and the output's
    gradient ``dout``; dK and dV summed over each KV head's query heads."""
    b, sq, nh, hd = q.shape
    kh = k.shape[2]
    g = nh // kh
    scale = hd ** -0.5 if scale is None else float(scale)
    qg = q.float().reshape(b, sq, kh, g, hd)
    dog = dout.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, None, None]
    p = torch.where(mask, torch.exp(s - lse.reshape(b, kh, g, sq, 1)), 0.0)
    dsum = (dout.float() * o.float()).sum(-1)                  # (B, Sq, NH)
    dsum = dsum.reshape(b, sq, kh, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", dog, vf) - dsum)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return (dq.reshape(b, sq, nh, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_decode_scores_ref(q: Tensor, k: Tensor) -> Tensor:
    """K8: q (B, 1, NH, d), k (B, L, KH, d) → s (B, NH, L) float32, the
    dot products over these d channels of query head h with KV head
    h // (NH // KH); no scale, no mask."""
    b, _, nh, d = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, kh, nh // kh, d)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k.float())
    return s.reshape(b, nh, k.shape[1])


def flash_decode_pv_ref(s: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: float) -> Tensor:
    """K9: the summed scores s (B, NH, L) float32, v (B, L, KH, d), q_pos
    (B, 1), kv_pos (B, L) → (B, 1, NH, d) in v's dtype: softmax over the
    visible keys (:func:`position_mask`'s rule) of scale·s, times v, in
    float32; 0 for a row that sees no key."""
    b, nh, length = s.shape
    kh, d = v.shape[2], v.shape[3]
    mask = position_mask(q_pos, kv_pos, causal, window)[:, 0][:, None]
    x = torch.where(mask, s * scale, NEG_INF)
    m = x.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(x - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgl,blkd->bkgd", p.reshape(b, kh, nh // kh, length),
                     v.float())
    o = o / torch.where(l == 0.0, 1.0, l).reshape(b, kh, nh // kh, 1)
    return o.reshape(b, 1, nh, d).to(v.dtype)
