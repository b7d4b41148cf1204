"""CUDA flash attention, forward and backward: build, binding, wrappers.

``csrc/flash.cu`` holds K6 ``flash_attention_fwd`` (see its header for
what it replaces, what bounds each of its two paths and why they look as
they do); ``csrc/flash_bwd.cu`` holds K7 ``flash_attention_bwd``, its
backward (which replaces no TPU kernel: the JAX package differentiates
``attention_xla`` through XLA; see its header for its two paths).  Both
are built with the port's other kernels into one library at first use
(``kernels/_build.py``); nothing is built at import.

* :func:`plan` — which path a call takes and how many cache slots a block
  of the split path owns, from the shapes alone (the one source of truth;
  the C entry takes its answer and recomputes nothing).
* :func:`flash_attention_fwd` — the wrapper: position-masked GQA attention
  over (B, S, heads, hd) tensors.  It takes the plain version (``ref.py``)
  for tensors on the CPU, and only for those.  For CUDA tensors it checks
  device, dtype, shape, contiguity and alignment, allocates the output and
  the split path's scratch, launches on the current stream (one C call:
  the split and merge kernels, or the MMA kernel), raises if the launch
  fails, and adds one to its launch count.  With ``return_lse`` it also
  returns each row's log-sum-exp (B, NH, Sq) in float32, which K7 reads.
* :func:`bwd_plan` — K7's path from the shapes alone: ``"mma"`` (the
  tensor cores, ``wgmma``) for bfloat16 at hd 64 and 128 (the LM's
  training, whisper), ``"fma"`` (float32 FMAs) for float32, hd 32 and hd
  256.  The C entry takes the answer and recomputes nothing; a CUDA call
  never falls back to the other path.
* :func:`flash_attention_bwd` — K7's wrapper: (dQ, dK, dV) from q, k, v,
  K6's output and log-sum-exp and the output's gradient; the plain
  version (``ref.py``) for CPU tensors, K7 for CUDA tensors (one C call,
  three kernels on :func:`bwd_plan`'s path), with its own launch count.
* :func:`enqueue` — the wrapper past its checks, for a given plan: the
  allocations and the one C call.
* :func:`attention` — the same function as an autograd op: the LM's
  attention, with and without its KV cache.  When q, k or v needs a
  gradient the forward asks K6 for the log-sum-exp and keeps q, k, v, the
  output and it; the backward is K7 on CUDA tensors and the plain
  backward on CPU tensors.  Serving (no gradient) writes no log-sum-exp.
  Its window follows the LM's ``attention_xla``: 0 means none.
* :func:`flash_attention` and :func:`flash_attention_bhsd` — the JAX
  package's single-head and (B, H, S, D) entry points, with the Pallas
  kernel's suffix-aligned causal semantics, through the same kernel.  Their
  window follows the Pallas kernel: None means none, and any given window
  w hides keys at positions ≤ i − w (w ≤ 0 with causal hides every key).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import (check_launch, check_tensor, declare,
                                        on_cpu)
from repro_torch.kernels._build import lib as _lib
from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,
                                           flash_attention_fwd_ref)

Tensor = torch.Tensor

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"split": 0, "mma": 1}
_BWD_PATHS = {"fma": 0, "mma": 1}

TILE_KEYS = 32                   # keys of a split-path tile
SPLIT_ROWS = 16                  # (query, group head) rows of a split block
SPLIT_LEN = 64                   # least cache slots a decode split owns
MAX_SPLIT_LEN = 1024             # most
SPLITS = 8                       # splits a decode (row, KV head) aims at
MMA_ROWS = 64                    # (query, group head) rows of one wgmma M
MMA_HEAD_DIMS = (64, 128)

# launches of K6 and K7; read and reset by callers that must show the main
# path went through the kernels (chip_smoke.py, ServeEngine stats)
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
declare("flash_attention_fwd",
        [_P] * 8 + [_I] * 10 + [ctypes.c_float, _I, _I, _P], _I)
declare("flash_attention_bwd",
        [_P] * 12 + [_I] * 10 + [ctypes.c_float, _I, _P], _I)


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, sq: int, nh: int, kh: int, hd: int,
         sk: int) -> Tuple[str, int]:
    """(path, split_len) of a K6 call. ``"mma"`` (the tensor cores; a block
    walks the whole cache, split_len 0) for bfloat16 with Sq·G ≥ 64 rows
    and hd ∈ {64, 128}; otherwise ``"split"`` (hd 256 too): blocks of
    split_len consecutive cache slots and a fixed-order merge (decode
    steps, small chunks, every float32 call). With more than SPLIT_ROWS
    rows the row blocks fill the grid and the cache is one split (scratch
    of about the output's size). Otherwise split_len is the power of two
    that spreads the cache over about SPLITS blocks, within [SPLIT_LEN,
    MAX_SPLIT_LEN]: 64 at Sk=512 and 512 at Sk=4096, the fastest of 32–1024
    and one split at both on the H100 (``flash_ab.py``; readings in
    PERF.md). It reads its arguments only, never B or the positions, so a
    batch row computes the same alone and in a batch."""
    rows = sq * (nh // kh)
    if dtype == torch.bfloat16 and rows >= MMA_ROWS and hd in MMA_HEAD_DIMS:
        return "mma", 0
    if rows > SPLIT_ROWS:
        return "split", max(TILE_KEYS, -(-sk // TILE_KEYS) * TILE_KEYS)
    per_split = -(-sk // SPLITS)
    split_len = 1 << max(0, per_split - 1).bit_length()
    return "split", min(MAX_SPLIT_LEN, max(SPLIT_LEN, split_len))


@functools.lru_cache(maxsize=1024)
def bwd_plan(dtype: torch.dtype, sq: int, nh: int, kh: int, hd: int,
             sk: int) -> str:
    """K7's path: ``"mma"`` (``wgmma`` with P and dS split into bf16 hi
    + lo) for bfloat16 with hd ∈ {64, 128}; ``"fma"`` (float32 FMAs from
    shared memory) otherwise: every float32 call, hd 32 (the f32 hpo_train
    twin) and hd 256 (recurrentgemma-9b).  It reads its arguments only,
    never B or the positions; any Sq, Sk, NH and KH (ragged tiles are
    masked), which it takes only so that it reads as :func:`plan`."""
    return "mma" if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS else "fma"


def bwd_plan_of(q: Tensor, k: Tensor) -> str:
    """:func:`bwd_plan` of a call with q (B, Sq, NH, hd) and k (B, Sk,
    KH, hd)."""
    _, sq, nh, hd = q.shape
    return bwd_plan(q.dtype, sq, nh, k.shape[2], hd, k.shape[1])


def plan_of(q: Tensor, k: Tensor) -> Tuple[str, int]:
    """:func:`plan` of a call with q (B, Sq, NH, hd) and k (B, Sk, KH, hd)."""
    _, sq, nh, hd = q.shape
    return plan(q.dtype, sq, nh, k.shape[2], hd, k.shape[1])


def n_splits(sk: int, split_len: int) -> int:
    """Blocks a (batch row, KV head) spreads its cache over: ceil(Sk /
    split_len), at least 1; 1 on the MMA path (split_len 0)."""
    return max(1, -(-sk // split_len)) if split_len else 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                        kv_pos: Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """K6: q (B, Sq, NH, hd), k/v (B, Sk, KH, hd), q_pos (B, Sq) and
    kv_pos (B, Sk) int32 → (B, Sq, NH, hd) in q's dtype; with
    ``return_lse``, (that, lse (B, NH, Sq) float32), +inf for a row that
    sees no key.

    ``window`` None means no window; a window w (any sign) hides keys at
    positions ≤ q_pos − w, the Pallas kernel's rule.
    """
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash attention takes q (B, Sq, NH, hd) and k/v "
                         "(B, Sk, KH, hd)")
    b, sq, nh, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if kh < 1 or nh % kh:
        raise ValueError(f"{nh} query heads do not group over {kh} KV heads")
    if on_cpu(q, meta=True):
        return flash_attention_fwd_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, scale=scale,
                                       return_lse=return_lse)
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, x, shape, dtype in (
            ("q", q, (b, sq, nh, hd), q.dtype),
            ("k", k, (b, sk, kh, hd), q.dtype),
            ("v", v, (b, sk, kh, hd), q.dtype),
            ("q_pos", q_pos, (b, sq), torch.int32),
            ("kv_pos", kv_pos, (b, sk), torch.int32)):
        check_tensor(name, x, shape, dtype, dev)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check_window(window)
    scale = hd ** -0.5 if scale is None else float(scale)
    lse = (torch.empty((b, nh, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    with torch.cuda.device(dev):
        out = enqueue(_lib().flash_attention_fwd, q, k, v, q_pos, kv_pos,
                      causal, window, scale, *plan_of(q, k), lse=lse)
    LAUNCHES["flash_attention_fwd"] += 1
    return (out, lse) if return_lse else out


def _check_window(window: Optional[int]) -> None:
    if window is not None and not -2 ** 31 < window < 2 ** 31:
        raise ValueError(f"window {window} is outside (-2³¹, 2³¹)")


def enqueue(entry, q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
            kv_pos: Tensor, causal: bool, window: Optional[int],
            scale: float, path: str, split_len: int,
            lse: Optional[Tensor] = None) -> Tensor:
    """The wrapper past its checks: allocate the output and the split
    path's scratch, call ``entry`` (the C entry ``flash_attention_fwd``)
    on the current stream with the given plan, raise if it failed; the
    log-sum-exp goes to ``lse`` when given.  ``flash_ab.py`` times it with
    other plans."""
    b, sq, nh, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    # split path: per (row, split) partials m, l and acc[hd], in float32
    scratch = (torch.empty(b * sq * nh * n_splits(sk, split_len) * (hd + 2),
                           dtype=torch.float32, device=q.device)
               if path == "split" else None)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, sq, sk,
                nh, kh, hd, _DTYPES[q.dtype], int(causal),
                int(window is not None), int(window or 0), scale,
                _PATHS[path], split_len,
                torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention_fwd", err)
    return out


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                        lse: Tensor, dout: Tensor, q_pos: Tensor,
                        kv_pos: Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K7: the gradients (dQ, dK, dV) of :func:`flash_attention_fwd` at
    q, k, v (its arguments), given its output ``out``, its ``lse`` (from
    ``return_lse``) and the output's gradient ``dout`` (B, Sq, NH, hd).
    dK and dV sum each KV head's query heads.  The plain version on CPU
    tensors; K7 on CUDA tensors, on :func:`bwd_plan`'s path (raises if the
    launch fails)."""
    b, sq, nh, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if on_cpu(q, meta=True):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, q_pos,
                                       kv_pos, causal=causal, window=window,
                                       scale=scale)
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if kh < 1 or nh % kh:
        raise ValueError(f"{nh} query heads do not group over {kh} KV heads")
    for name, x, shape, dtype in (
            ("q", q, (b, sq, nh, hd), q.dtype),
            ("k", k, (b, sk, kh, hd), q.dtype),
            ("v", v, (b, sk, kh, hd), q.dtype),
            ("out", out, (b, sq, nh, hd), q.dtype),
            ("lse", lse, (b, nh, sq), torch.float32),
            ("dout", dout, (b, sq, nh, hd), q.dtype),
            ("q_pos", q_pos, (b, sq), torch.int32),
            ("kv_pos", kv_pos, (b, sk), torch.int32)):
        check_tensor(name, x, shape, dtype, dev)
    _check_window(window)
    path = bwd_plan_of(q, k)
    if path == "mma":
        for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    scale = hd ** -0.5 if scale is None else float(scale)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty((b, nh, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dsum.data_ptr(), b, sq, sk, nh, kh, hd, _DTYPES[q.dtype],
            int(causal), int(window is not None), int(window or 0), scale,
            _BWD_PATHS[path], torch.cuda.current_stream(dev).cuda_stream)
    check_launch("flash_attention_bwd", err)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, scale):
        ctx.args = (causal, window, scale)
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_fwd(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, scale=scale)
        out, lse = flash_attention_fwd(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, scale=scale,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         q_pos, kv_pos, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
              kv_pos: Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              scale: Optional[float] = None) -> Tensor:
    """Position-masked GQA attention (the LM's): K6 forward and K7
    backward on CUDA tensors, the plain versions on CPU tensors.
    ``window`` 0 or None means none, as in ``attention_xla``."""
    return _FlashFn.apply(q, k, v, q_pos, kv_pos, causal, window or None,
                          scale)


def _suffix_positions(b: int, sq: int, sk: int, device) -> tuple:
    """The Pallas kernel's positions: query i at Sk − Sq + i, key j at j."""
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32, device=device)
    kv_pos = torch.arange(sk, dtype=torch.int32, device=device)
    return (q_pos.expand(b, sq).contiguous(),
            kv_pos.expand(b, sk).contiguous())


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> Tensor:
    """Single-head attention, q (Sq, H), k/v (Sk, H) → (Sq, H), with the
    Pallas kernel's semantics: suffix-aligned queries, optional causal mask
    and local window (i − window, i] whenever ``window`` is not None (so
    ``window=0`` with causal masks every key), fully masked rows → 0."""
    sq, h = q.shape
    sk = k.shape[0]
    q_pos, kv_pos = _suffix_positions(1, sq, sk, q.device)
    return flash_attention_fwd(q.reshape(1, sq, 1, h), k.reshape(1, sk, 1, h),
                               v.reshape(1, sk, 1, h), q_pos, kv_pos,
                               causal=causal, window=window,
                               scale=scale).reshape(sq, h)


def flash_attention_bhsd(q: Tensor, k: Tensor, v: Tensor, **kw) -> Tensor:
    """(B, H, S, D) layout: every (batch, head) pair is one single-head
    :func:`flash_attention`, in one launch."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q_pos, kv_pos = _suffix_positions(b, sq, sk, q.device)
    out = flash_attention_fwd(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), q_pos, kv_pos,
                              **kw)
    return out.transpose(1, 2)
