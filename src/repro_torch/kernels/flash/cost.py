"""What K6–K9 must do: the bytes, operations and peak rate of a call.

Each input is counted read once and each output written once, and the
operations are those of the pairs a call's masks leave visible, 2·hd a
product per (query head, visible key) pair: two products in K6 (q·kᵀ,
p·v), five in K7 (S, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K).  ``chip_smoke.py``
divides them by the card's rates (``launch/mesh.py``) for each kernel's
bound, and the dry run (``launch/dryrun.py``) for its attention time.

:func:`flash_cost` and :func:`flash_bwd_cost` count the pairs the given
positions leave visible (the work depends on the data: empty cache slots
and ragged rows), from the (B, Sq, Sk) mask.  :func:`fwd_cost` and
:func:`bwd_cost` count from the shapes alone, for calls whose positions
are not at hand (the dry run's, on meta tensors): query i at position
offset + i, key j at j, ``offset`` = Sk − Sq by default (the suffix
alignment of the Pallas kernel; 0 for self-attention over a sequence,
Sk − 1 for a decode step over a full cache), in closed form, so no S²
mask is built (prefill_32k's would be 34 GB).

:func:`decode_scores_cost` (K8) counts every slot, since K8 masks
nothing: q and k read once, the float32 scores written once, 2·d
operations a (query head, slot).  :func:`decode_pv_cost` (K9) counts
what the positions leave visible: the visible scores read once, the V
rows some head sees read once, the positions and the output; 2·d
operations a visible (query head, key) pair.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash.ref import position_mask
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_F32

Tensor = torch.Tensor
Cost = Tuple[int, int, float]          # (bytes, operations, FLOP/s)


def _intervals(sq: int, sk: int, causal: bool, window: Optional[int],
               offset: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The keys [lo_i, hi_i] query i sees (empty where lo > hi): the rule
    of ``ref.position_mask`` with query i at offset + i and key j at j."""
    off = sk - sq if offset is None else offset
    pos = off + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(pos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return lo, hi


def visible_pairs(sq: int, sk: int, causal: bool = True,
                  window: Optional[int] = None,
                  offset: Optional[int] = None) -> int:
    """(query, key) pairs one batch row's mask leaves visible."""
    lo, hi = _intervals(sq, sk, causal, window, offset)
    return int(np.maximum(hi - lo + 1, 0).sum())


def keys_seen(sq: int, sk: int, causal: bool = True,
              window: Optional[int] = None,
              offset: Optional[int] = None) -> int:
    """Keys of one batch row that some query sees.  The intervals move by
    at most one key a query, so the non-empty ones cover one run."""
    lo, hi = _intervals(sq, sk, causal, window, offset)
    live = hi >= lo
    return int(hi[live].max() - lo[live].min() + 1) if live.any() else 0


def _rate(dtype: torch.dtype) -> float:
    return PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32


def _k6(dtype: torch.dtype, b: int, sq: int, sk: int, nh: int, kh: int,
        hd: int, pairs: int, keys: int) -> Cost:
    """K6 over ``pairs`` visible (query, key) pairs and ``keys`` K/V rows
    that some query sees, all B rows together: q, out and the positions
    once, those K/V rows once; 4·hd operations a visible (head, pair)."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * sq * nh * hd * es + 2 * keys * kh * hd * es
              + 4 * b * (sq + sk))
    return nbytes, 4 * pairs * nh * hd, _rate(dtype)


def _k7(dtype: torch.dtype, b: int, sq: int, sk: int, nh: int, kh: int,
        hd: int, pairs: int) -> Cost:
    """K7 over ``pairs`` visible pairs: q, o, dO, dQ, k, v, dK, dV, lse
    and the positions once each; 10·hd operations a visible (head,
    pair)."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (4 * b * sq * nh * hd * es + 4 * b * sk * kh * hd * es
              + 4 * b * nh * sq + 4 * b * (sq + sk))
    return nbytes, 10 * pairs * nh * hd, _rate(dtype)


def fwd_cost(dtype: torch.dtype, b: int, sq: int, sk: int, nh: int,
             kh: int, hd: int, causal: bool = True,
             window: Optional[int] = None,
             offset: Optional[int] = None) -> Cost:
    """K6 from the shapes (closed-form pairs and keys)."""
    return _k6(dtype, b, sq, sk, nh, kh, hd,
               b * visible_pairs(sq, sk, causal, window, offset),
               b * keys_seen(sq, sk, causal, window, offset))


def bwd_cost(dtype: torch.dtype, b: int, sq: int, sk: int, nh: int,
             kh: int, hd: int, causal: bool = True,
             window: Optional[int] = None,
             offset: Optional[int] = None) -> Cost:
    """K7 from the shapes (closed-form pairs)."""
    return _k7(dtype, b, sq, sk, nh, kh, hd,
               b * visible_pairs(sq, sk, causal, window, offset))


def flash_cost(q: Tensor, k: Tensor, q_pos: Tensor, kv_pos: Tensor,
               causal: bool = True, window: Optional[int] = None) -> Cost:
    """(bytes, operations, peak rate) K6 needs on these inputs (q (B, Sq,
    NH, hd), k (B, Sk, KH, hd)): the pairs and keys the positions leave
    visible."""
    mask = position_mask(q_pos, kv_pos, causal, window)      # (B, Sq, Sk)
    b, sq, nh, hd = q.shape
    return _k6(q.dtype, b, sq, k.shape[1], nh, k.shape[2], hd,
               int(mask.sum()), int(mask.any(1).sum()))


def flash_bwd_cost(q: Tensor, k: Tensor, q_pos: Tensor, kv_pos: Tensor,
                   causal: bool = True, window: Optional[int] = None
                   ) -> Cost:
    """The same for K7: the visible pairs of these positions."""
    b, sq, nh, hd = q.shape
    return _k7(q.dtype, b, sq, k.shape[1], nh, k.shape[2], hd,
               int(position_mask(q_pos, kv_pos, causal, window).sum()))


def decode_scores_cost(q: Tensor, k: Tensor) -> Cost:
    """(bytes, operations, peak rate) K8 needs on q (B, 1, NH, d) and k
    (B, L, KH, d)."""
    b, _, nh, d = q.shape
    length = k.shape[1]
    es = q.element_size()
    nbytes = q.numel() * es + k.numel() * es + 4 * b * nh * length
    return nbytes, 2 * b * nh * length * d, _rate(q.dtype)


def decode_pv_cost(s: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
                   causal: bool = True, window: Optional[int] = None
                   ) -> Cost:
    """The same for K9 on the summed scores s (B, NH, L) and v (B, L, KH,
    d): the pairs and V rows these positions leave visible."""
    b, nh, length = s.shape
    kh, d = v.shape[2], v.shape[3]
    seen = int(position_mask(q_pos, kv_pos, causal, window).sum())
    es = v.element_size()
    nbytes = (4 * nh * seen + seen * kh * d * es + 4 * b * (1 + length)
              + b * nh * d * es)
    return nbytes, 2 * nh * seen * d, _rate(v.dtype)
