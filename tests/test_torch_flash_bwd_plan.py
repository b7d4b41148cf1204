"""K7's path (``repro_torch.kernels.flash.kernel.bwd_plan``) and the
precision design of its MMA path, on the CPU.

``bwd_plan`` sends bfloat16 calls at hd 64 and 128 to the tensor cores
(``wgmma``) and everything else (float32, hd 32, hd 256) to the float32
FMA kernels, from the shapes alone.  The MMA path computes S and dP from
bf16 inputs (exact products, float32 sums) and feeds P and dS to the next
products as bf16 hi + lo pairs; :func:`emulate` repeats that arithmetic
in float32 here.  Held to the plain version (``flash_attention_bwd_ref``)
with ``chip_smoke.py``'s limit (1e-4 of a gradient's largest entry plus
one bf16 rounding of the entry), the split passes and one bf16 rounding
of P and dS fails, which is why the kernel splits them.  The kernels'
own bits are checked on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import inspect
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash import kernel as K  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,  # noqa: E402,E501
                                           flash_attention_fwd_ref,
                                           position_mask)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4                # chip_smoke.py's K7_F32_TOL
LOG2E = 1.4426950408889634


def train_k7_cases():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke.TRAIN_K7


# the path each of chip_smoke.py's K7 cases takes
TRAIN_K7_PATHS = {
    "slice: llama3.2-3b B=4 S=512": "mma",
    "f32 hd 64 ragged S=300 window 128": "fma",
    "qwen3 heads G=8 S=256": "mma",
    "recurrentgemma NH=16 KH=1 hd 256 window 2048 S=2560": "fma",
    "whisper encoder B=2 S=1500 not causal": "mma",
    "whisper cross Sq=64 over 1500": "mma",
    "no visible key: window 0, causal": "fma",
    "bf16 hd 128 ragged S=300 window 128 G=3": "mma",
    "bf16 hd 64 no visible key: window 0, causal": "mma",
    "mesh (b): llama3.2-3b TP=2 B=4 S=512": "mma",
    "mesh (a): reduced llama f32 on (2, 2) B=1 S=16": "fma",
    "mesh (c): recurrentgemma-9b TP=2 B=4 S=512": "fma",
}


def test_bwd_plan_reads_shapes_only():
    assert list(inspect.signature(K.bwd_plan).parameters) == [
        "dtype", "sq", "nh", "kh", "hd", "sk"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", K.HEAD_DIMS)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (512, 24, 8, 512),
                                   (300, 6, 2, 300), (64, 8, 8, 1500),
                                   (96, 32, 4, 0)])
def test_bwd_plan_is_mma_exactly_for_bf16_hd_64_and_128(dtype, hd, shape):
    sq, nh, kh, sk = shape
    want = ("mma" if dtype == torch.bfloat16 and hd in (64, 128)
            else "fma")
    assert K.bwd_plan(dtype, sq, nh, kh, hd, sk) == want


@pytest.mark.parametrize("b", [1, 4])
def test_bwd_plan_ignores_batch_and_positions(b):
    q = torch.zeros((b, 40, 6, 128), dtype=torch.bfloat16)
    k = torch.zeros((b, 70, 2, 128), dtype=torch.bfloat16)
    assert K.bwd_plan_of(q, k) == K.bwd_plan(torch.bfloat16, 40, 6, 2, 128,
                                             70) == "mma"


@pytest.mark.parametrize("case", train_k7_cases(), ids=lambda c: c[0])
def test_every_train_k7_case_takes_its_path(case):
    tag, _, sq, sk, nh, kh, hd, dtype = case[:8]
    assert K.bwd_plan(getattr(torch, dtype), sq, nh, kh, hd,
                      sk) == TRAIN_K7_PATHS[tag]


def test_train_k7_cases_are_all_named():
    assert sorted(c[0] for c in train_k7_cases()) == sorted(TRAIN_K7_PATHS)


# ----------------------------------------- the MMA path's arithmetic
def bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, o, lse, dout, q_pos, kv_pos, causal, window,
            split=True):
    """(dQ, dK, dV) as the MMA path computes them: S and dP from the bf16
    inputs (exact products, float32 sums), P = 2^(S·c − lse·log2 e) with
    c = scale·log2 e where seen, dS = P∘(dP − D), then dV = Pᵀ·dO, dK =
    scale·dSᵀ·Q and dQ = scale·dS·K with P and dS as bf16 hi + lo
    (``split``) or rounded once to bf16, in the inputs' dtype."""
    b, sq, nh, hd = q.shape
    kh = k.shape[2]
    g = nh // kh
    scale = hd ** -0.5
    c = np.float32(scale * LOG2E)
    qg = q.float().reshape(b, sq, kh, g, hd)
    dog = dout.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    mask = position_mask(q_pos, kv_pos, causal, window)[:, None, None]
    nl = -(lse.reshape(b, kh, g, sq, 1) * np.float32(LOG2E))
    p = torch.where(mask, torch.exp2(s * c + nl), 0.0)
    dsum = (dout.float() * o.float()).sum(-1)
    dsum = dsum.reshape(b, sq, kh, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - dsum)

    def parts(x):
        hi = bf16(x)
        return (hi, bf16(x - hi)) if split else (hi,)

    dv = sum(torch.einsum("bkgqs,bqkgh->bskh", x, dog) for x in parts(p))
    dk = sum(torch.einsum("bkgqs,bqkgh->bskh", x, qg) for x in parts(ds))
    dq = sum(torch.einsum("bkgqs,bskh->bqkgh", x, kf) for x in parts(ds))
    return ((dq * scale).reshape(b, sq, nh, hd).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


def worst_ratio(got, ref):
    """max |Δ| / limit over a gradient's entries, the limit chip_smoke.py's
    k7_err: 1e-4 · max|ref| + 2⁻⁷ · |ref| for bf16."""
    d = (got.float() - ref.float()).abs()
    lim = TOL * ref.float().abs().max() + 2.0 ** -7 * ref.float().abs()
    return float((d / lim.clamp_min(1e-30)).max())


# (B, Sq, Sk, NH, KH, hd, causal, window in the Pallas rule, query
# positions): reduced forms of chip_smoke.py's MMA cases
EMU_CASES = {
    "causal": (1, 256, 256, 6, 2, 128, True, None, "self"),
    "window": (1, 200, 200, 4, 2, 64, True, 48, "self"),
    "gqa8": (1, 128, 128, 8, 1, 64, True, None, "self"),
    "cross": (2, 64, 300, 4, 4, 64, False, None, "zero"),
    "no_visible_key": (2, 96, 96, 4, 2, 64, True, 0, "self"),
}


def emu_inputs(case, seed):
    b, sq, sk, nh, kh, hd, causal, window, qpos = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(torch.bfloat16)
        for sh in ((b, sq, nh, hd), (b, sk, kh, hd), (b, sk, kh, hd),
                   (b, sq, nh, hd)))
    kp = torch.arange(sk, dtype=torch.int32).expand(b, sk).contiguous()
    qp = (torch.arange(sq, dtype=torch.int32).expand(b, sq).contiguous()
          if qpos == "self" else torch.zeros((b, sq), dtype=torch.int32))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd_ref(q, k, v, qp, kp, return_lse=True, **kw)
    return (q, k, v, o, lse, do, qp, kp), kw


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_split_p_and_ds_stay_within_k7_limit(name):
    args, kw = emu_inputs(EMU_CASES[name], 0)
    refs = flash_attention_bwd_ref(*args, **kw)
    got = emulate(*args, **kw)
    for g, r in zip(got, refs):
        assert worst_ratio(g, r) <= 1.0
    seen = position_mask(args[6], args[7], **kw)
    rows, keys = seen.any(-1), seen.any(1)
    assert not got[0][~rows].any()
    assert not got[1][~keys].any() and not got[2][~keys].any()
    if name == "no_visible_key":
        assert all(not x.any() for x in got)


@pytest.mark.parametrize("name", ["causal", "window", "gqa8", "cross"])
def test_one_bf16_rounding_of_p_and_ds_exceeds_k7_limit(name):
    args, kw = emu_inputs(EMU_CASES[name], 0)
    refs = flash_attention_bwd_ref(*args, **kw)
    got = emulate(*args, split=False, **kw)
    assert max(worst_ratio(g, r) for g, r in zip(got, refs)) > 1.0
    assert math.isfinite(max(float(g.float().abs().max()) for g in got))
