"""K8's and K9's path (``repro_torch.kernels.flash.kernel.decode_plan``)
and the arithmetic of their MMA path, on the CPU.

``decode_plan`` sends bfloat16 calls with d a multiple of 16 to the
tensor cores (``mma.sync.m16n8k16``) and everything else to the
float32 FMA kernels, from the shapes alone.  On the MMA path K8 sums each
k-step's 16 exact bf16 products and adds the k-steps in order in float32;
K9 runs a cluster of blocks per (batch row, KV head): each block takes
its maxima of scale·s over its visible keys, every block the row's M over
the blocks in rank order, P = exp(scale·s − M) enters P·V as a bf16 hi +
lo pair, 16-key tiles with no visible key are not read, and the blocks'
partials and sums are added in rank order.  :func:`emulate_scores` and
:func:`emulate_pv` repeat that order and those splits here, held to the
plain versions at ``chip_smoke.py``'s limits (``SPLIT_SCORES_TOL`` ·
max|s| for K8, ``flash_tol`` on live rows and exactly 0 on the idle row
for K9); one bf16 rounding of P misses K9's limit, which is why the
kernel splits it.  The kernels' own bits are checked on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import inspect
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash import kernel as K  # noqa: E402
from repro_torch.kernels.flash.cost import decode_pv_cost  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_decode_pv_ref,  # noqa: E402,E501
                                           flash_decode_scores_ref,
                                           position_mask)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG2E = 1.4426950408889634


def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    return cs


CS = chip_smoke()

# the path each of chip_smoke.py's split decode cases takes
SPLIT_DECODE_PATHS = {
    "(c): recurrentgemma-9b on 2": "mma",
    "recurrentgemma-9b on 4": "mma",
    "chatglm3-6b on 4": "mma",
    "starcoder2-15b on 8": "mma",
    "recurrentgemma-9b on 4, window 7": "mma",
    "(c) in float32": "fma",
    "bfloat16 at d = 24": "fma",
}
MMA_CASES = [c for c in CS.SPLIT_DECODE_CASES if c[-1] == "mma"]
# a cache long enough that a K9 block runs its keys in 3 rounds of 128
LONG_CASE = ("long cache: 3 rounds a block", 2, 4100, 8, 2, 64, 2,
             "bfloat16", None, "mma")


def test_decode_plan_reads_shapes_only():
    assert list(inspect.signature(K.decode_plan).parameters) == [
        "dtype", "nh", "kh", "d"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 64, 100, 128, 256])
@pytest.mark.parametrize("heads", [(16, 1), (48, 4)])
def test_decode_plan_is_mma_exactly_for_bf16_d_multiple_of_16(dtype, d,
                                                              heads):
    want = "mma" if dtype == torch.bfloat16 and d % 16 == 0 else "fma"
    assert K.decode_plan(dtype, *heads, d) == want


@pytest.mark.parametrize("case", CS.SPLIT_DECODE_CASES, ids=lambda c: c[0])
def test_every_split_decode_case_takes_its_path(case):
    tag, _, _, nh, kh, d, _, dtype, _, path = case
    assert K.decode_plan(getattr(torch, dtype), nh, kh, d) == path
    assert path == SPLIT_DECODE_PATHS[tag]


@pytest.mark.parametrize("length,most,want", [
    (2048, 16, 16), (2048, 8, 8), (512, 16, 4), (4100, 16, 16), (255, 16, 1),
    (256, 16, 2), (100, 16, 1), (1, 16, 1), (4096, 16, 16), (1024, 16, 8)])
def test_decode_cluster_leaves_each_block_a_round(length, most, want):
    n = K.decode_cluster(length, most)
    assert n == want
    assert n == 1 or -(-length // n) >= K.DECODE_ROUND


def test_split_decode_cases_are_all_named():
    assert sorted(c[0] for c in CS.SPLIT_DECODE_CASES) == sorted(
        SPLIT_DECODE_PATHS)


# ----------------------------------------- the MMA path's arithmetic
def bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_scores(q, k):
    """K8's MMA path: per query head and key, the k-steps' sums of 16
    exact bf16 products (float64, then float32) added in order in
    float32."""
    b, _, nh, d = q.shape
    length, kh = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, kh, nh // kh, d // 16, 16)
    kk = k.double().reshape(b, length, kh, d // 16, 16)
    steps = torch.einsum("bkgtc,blktc->tbkgl", qg, kk).float()
    s = torch.zeros(steps.shape[1:], dtype=torch.float32)
    for t in steps:
        s = s + t
    return s.reshape(b, nh, length)


def pv_geometry(length):
    """(keys a block, blocks): kernel.py's K9 MMA cluster on a card that
    takes clusters of 16."""
    cluster = K.decode_cluster(length)
    kpb = -(-(-(-length // cluster)) // K.DECODE_TILE) * K.DECODE_TILE
    return kpb, cluster


def emulate_pv(s, v, q_pos, kv_pos, causal, window, scale, split=True):
    """K9's MMA path, as one cluster per (batch row, KV head): block r
    owns keys [r·kpb, (r+1)·kpb) in rounds of 128; its max of scale·s over
    its visible keys; M the max over the blocks in rank order; P =
    2^((scale·s − M)·log2 e) on visible keys (0 elsewhere) with l its
    float32 sum; per round, the 16-key tiles' products in order (a tile's
    16 products summed in float64, then float32; V of a tile with no
    visible key is not read but zero-filled, so it adds zeros) into two
    accumulators, P's bf16 hi and lo halves (``split``; else P rounded once
    to bf16, hi alone), added at the round's end; the rounds into the
    block's partial; the partials and sums added in rank order; out =
    partial / L (0 where L = 0), in v's dtype.  → (out, V rows read)."""
    b, nh, length = s.shape
    kh, d = v.shape[2], v.shape[3]
    g = nh // kh
    kpb, blocks = pv_geometry(length)
    tile, rnd = K.DECODE_TILE, K.DECODE_ROUND
    pad = blocks * kpb - length
    mask = position_mask(q_pos, kv_pos, causal, window)[:, 0]      # (B, L)
    mask = torch.nn.functional.pad(mask, (0, pad))
    x = torch.where(mask[:, None], torch.nn.functional.pad(
        s.float() * np.float32(scale), (0, pad)), float("-inf"))
    x = x.reshape(b, kh, g, blocks, kpb)
    m = torch.full((b, kh, g), float("-inf"))
    for r in range(blocks):                          # rank order
        m = torch.maximum(m, x[..., r, :].amax(-1))
    seen = mask.reshape(b, 1, 1, blocks, kpb)
    p = torch.where(seen, torch.exp2((x - m[..., None, None])
                                     * np.float32(LOG2E)), 0.0)
    hi = bf16(p)
    parts = (hi, bf16(p - hi)) if split else (hi,)
    tiles = seen.reshape(b, 1, 1, blocks, kpb // tile, tile).any(-1)
    vb = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    vb = vb.reshape(b, blocks, kpb // tile, tile, kh, d)
    vb = vb * tiles.reshape(b, blocks, kpb // tile, 1, 1, 1)   # unread: 0
    vb = vb.reshape(b, blocks, kpb, kh, d)
    part = torch.zeros((b, kh, g, blocks, d))
    for r0 in range(0, kpb, rnd):
        accs = [torch.zeros((b, kh, g, blocks, d)) for _ in parts]
        for t0 in range(r0, min(r0 + rnd, kpb), tile):
            vt = vb[:, :, t0:t0 + tile].double()
            for i, x_ in enumerate(parts):
                prod = torch.einsum("bkgrj,brjkc->bkgrc",
                                    x_[..., t0:t0 + tile].double(), vt)
                accs[i] = accs[i] + prod.float()
        part = part + (accs[0] + accs[1] if split else accs[0])
    lb = p.sum(-1)                                   # (B, KH, G, blocks)
    o = torch.zeros((b, kh, g, d))
    big_l = torch.zeros((b, kh, g))
    for r in range(blocks):                          # rank order
        o = o + part[..., r, :]
        big_l = big_l + lb[..., r]
    o = torch.where(big_l[..., None] > 0, o / big_l[..., None], 0.0)
    rows_read = int(tiles.any(1).any(1).sum()) * tile
    return o.reshape(b, 1, nh, d).to(v.dtype), rows_read


def case_inputs(case):
    """A chip_smoke.py case's inputs on the CPU, the scores summed over
    its ranks, K9's keywords."""
    tag, b, length, nh, kh, d, ranks, dtype, window, _ = case
    q, k, v, qp, kp = CS.split_decode_inputs("cpu", b, length, nh, kh, d,
                                             dtype, window)
    s = flash_decode_scores_ref(q, k) * float(ranks)
    return (q, k, v, qp, kp), s, dict(causal=True, window=window,
                                      scale=(d * ranks) ** -0.5)


def pv_ratio(out, ref, seen):
    """max |Δ| / flash_tol over the live rows."""
    lim = torch.as_tensor(CS.flash_tol(ref))
    r = (out.float() - ref.float()).abs() / lim
    return float(r[seen].max())


@pytest.mark.parametrize("case", MMA_CASES, ids=lambda c: c[0])
def test_k8_mma_sums_stay_within_limit(case):
    (q, k, *_), _, _ = case_inputs(case)
    ref = flash_decode_scores_ref(q, k)
    got = emulate_scores(q, k)
    assert float((got - ref).abs().max()) <= (
        CS.SPLIT_SCORES_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("case", MMA_CASES + [LONG_CASE], ids=lambda c: c[0])
def test_k9_mma_split_p_stays_within_limit(case):
    (_, _, v, qp, kp), s, kw = case_inputs(case)
    ref = flash_decode_pv_ref(s, v, qp, kp, **kw)
    got, _ = emulate_pv(s, v, qp, kp, **kw)
    seen = position_mask(qp, kp, True, kw["window"]).any(-1)
    assert pv_ratio(got, ref, seen) <= 1.0
    assert not got[~seen].any()
    assert bool(torch.isfinite(got.float()).all())


def test_one_bf16_rounding_of_p_exceeds_k9_limit():
    """At (c)'s shape a single bf16 rounding of P misses ``flash_tol``
    where the split passes: K9 keeps the hi + lo pair."""
    (_, _, v, qp, kp), s, kw = case_inputs(CS.SPLIT_DECODE_CASES[0])
    ref = flash_decode_pv_ref(s, v, qp, kp, **kw)
    seen = position_mask(qp, kp, True, kw["window"]).any(-1)
    one, _ = emulate_pv(s, v, qp, kp, split=False, **kw)
    assert pv_ratio(one, ref, seen) > 1.0


def test_k9_mma_reads_the_visible_tiles_only():
    """At (c)'s shape the kernel reads V for the 16-key tiles that hold a
    visible slot: within one tile a row of ``decode_pv_cost``'s visible
    slots, none for the idle row."""
    (_, _, v, qp, kp), s, kw = case_inputs(CS.SPLIT_DECODE_CASES[0])
    _, rows = emulate_pv(s, v, qp, kp, **kw)
    visible = int(position_mask(qp, kp, True, kw["window"]).sum())
    assert visible <= rows <= visible + K.DECODE_TILE * v.shape[0]
    nbytes, _, _ = decode_pv_cost(s, v, qp, kp, True, kw["window"])
    assert nbytes < 0.7 * (s.numel() * 4 + v.numel() * v.element_size())
