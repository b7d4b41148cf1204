"""Plain PyTorch version of the flash-attention kernel K6.

The CPU path of the kernel wrapper, and what ``chip_smoke.py`` holds the
kernel against on the card.  Masking is by position, as on the serving
path (``repro/models/layers.py::attention_xla``): key j of row b is seen
by query i when ``kv_pos[b, j] >= 0`` and, if causal,
``kv_pos[b, j] <= q_pos[b, i]`` and, with a window w (not None, any
sign: the Pallas kernel's rule), ``kv_pos[b, j] > q_pos[b, i] - w``.  A query with no such key gets 0, as
in the Pallas kernel (``repro/kernels/flash/kernel.py:75-78``; the XLA
path would give the mean of v).  Scores, softmax and P·V are float32; the
output is in q's dtype.
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
                            scale: Optional[float] = None) -> Tensor:
    """q (B, Sq, NH, hd), k/v (B, Sk, KH, hd), q_pos (B, Sq), kv_pos (B, Sk)
    → (B, Sq, NH, hd).  Query head h reads KV head h // (NH // KH); the KV
    heads are never repeated."""
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
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, nh, hd).to(q.dtype)
