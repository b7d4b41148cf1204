"""Parity of the port's flash attention (kernel K6's plain version on the
CPU) with the JAX package on the Pallas test cases: the port's result and
the Pallas kernel's in interpret mode, each held against the package's
``attention_ref`` oracle evaluated in float64, and the serving path's
position-masked ``layers.attention_xla`` on GQA decode and prefill.

Inputs are drawn with numpy and handed to both packages (bf16 inputs are
rounded from the same float32 values on both sides).  Tolerances are those
of the JAX package's own flash test: 2e-5 in float32, 2e-2 in bfloat16.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash.kernel import flash_attention as jax_flash  # noqa: E402,E501
from repro.kernels.flash.kernel import \
    flash_attention_bhsd as jax_flash_bhsd  # noqa: E402
from repro.kernels.flash.ref import attention_ref  # noqa: E402
from repro.models.layers import attention_xla  # noqa: E402
from repro_torch.kernels.flash import kernel as K  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,  # noqa: E402
                                           flash_attention_fwd_ref)

FLASH_CASES = [
    (256, 256, 64, True, None, "float32"),
    (256, 256, 64, False, None, "float32"),
    (128, 384, 64, True, None, "float32"),    # suffix-aligned (cache)
    (300, 300, 32, True, 128, "float32"),     # local window, ragged
    (1, 513, 64, True, None, "float32"),      # single-query decode
    (128, 128, 64, True, None, "bfloat16"),   # dtype sweep
    (256, 256, 64, True, 0, "float32"),       # window 0: every key masked
    (128, 384, 64, False, 0, "float32"),      # window 0, not causal
    (96, 160, 256, True, 64, "float32"),      # hd 256 (recurrentgemma-9b)
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                getattr(torch, dtype)))


def t2np(t):
    return t.float().numpy()


@pytest.mark.parametrize("sq,sk,h,causal,window,dtype", FLASH_CASES)
def test_flash_attention_matches_pallas_and_oracle(sq, sk, h, causal, window,
                                                   dtype):
    rng = np.random.default_rng(sq + sk)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal((s, h)).astype(np.float32), dtype)
        for s in (sq, sk, sk))
    out = K.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == (sq, h)
    pallas = jax_flash(qj, kj, vj, causal=causal, window=window,
                       interpret=True)
    # each side against the JAX package's oracle in float64 (on the same,
    # possibly bf16-rounded, inputs), not against each other: two float32
    # results 2e-5 from the oracle can lie 4e-5 apart
    ref = attention_ref(qj.astype(jnp.float64), kj.astype(jnp.float64),
                        vj.astype(jnp.float64), causal=causal, window=window)
    assert ref.dtype == jnp.float64
    tol = TOL[dtype]
    np.testing.assert_allclose(t2np(out), np.asarray(ref), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(np.asarray(pallas, np.float64),
                               np.asarray(ref), atol=tol, rtol=tol)
    if causal and window is not None and window <= 0:
        assert not out.any()          # the Pallas rule: every key masked
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)  # CPU: plain


def test_flash_attention_bhsd_matches_pallas():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, s, 32)).astype(np.float32)
               for s in (40, 72, 72))
    out = K.flash_attention_bhsd(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=24)
    ref = jax_flash_bhsd(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                         window=24, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def serving_positions(b, sk, rng):
    """Per-row cache positions as the serving engine leaves them: row b
    has written positions 0..len_b−1 into slots 0..len_b−1, the rest of
    its slots are empty (−1), and the trash slot sk−1 holds −1; the last
    row is idle (query position −1, nothing visible)."""
    kv_pos = np.full((b, sk), -1, np.int32)
    q_pos = np.full((b, 1), -1, np.int32)
    for r in range(b - 1):
        n = int(rng.integers(1, sk - 1))
        kv_pos[r, :n] = np.arange(n)
        q_pos[r, 0] = n - 1
    return q_pos, kv_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_matches_serving_attention_on_live_rows(dtype):
    """Sq=1 over a cache with ragged positions, empty slots, the trash
    slot and an idle row, 6 query heads over 2 KV heads.  Live rows agree
    with ``attention_xla``; the idle row (no visible key) is 0 in the port
    (the Pallas kernel's convention) and the mean of v in ``attention_xla``,
    whose logits the engine discards."""
    rng = np.random.default_rng(11)
    b, sk, nh, kh, hd = 5, 48, 6, 2, 32
    q_pos, kv_pos = serving_positions(b, sk, rng)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((b, 1, nh, hd), (b, sk, kh, hd), (b, sk, kh, hd)))
    out = K.attention(qt, kt, vt, torch.from_numpy(q_pos),
                      torch.from_numpy(kv_pos), causal=True)
    ref = attention_xla(qj, kj, vj, causal=True, window=0,
                        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos))
    live = q_pos[:, 0] >= 0
    tol = TOL[dtype]
    np.testing.assert_allclose(t2np(out)[live],
                               np.asarray(ref, np.float32)[live],
                               atol=tol, rtol=tol)
    assert not torch.any(out[~torch.from_numpy(live)])


@pytest.mark.parametrize("window", [0, 7])
def test_prefill_positions_match_serving_attention(window):
    """Sq>1 self-attention with per-row position offsets (chunked prefill
    continuing a cache) and an optional local window."""
    rng = np.random.default_rng(3 + window)
    b, s, nh, kh, hd = 2, 20, 4, 2, 64
    q_pos = np.stack([np.arange(s), np.arange(s) + 9]).astype(np.int32)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, nh, hd), (b, s, kh, hd), (b, s, kh, hd)))
    out = K.attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos,
                                                      q_pos)),
                      causal=True, window=window)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=window, q_pos=jnp.asarray(q_pos),
                        kv_pos=jnp.asarray(q_pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_wrapper_takes_the_plain_version_on_cpu_and_has_no_backward():
    """The wrappers take the plain versions on CPU tensors: K6's forward
    (with and without the log-sum-exp) and, since the backward exists
    (K7), ``attention``'s backward is the plain backward, bitwise."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, 4, 2, 32), (1, 9, 1, 32), (1, 9, 1, 32)))
    qp = torch.arange(5, 9, dtype=torch.int32)[None]
    kp = torch.arange(9, dtype=torch.int32)[None]
    assert torch.equal(K.flash_attention_fwd(q, k, v, qp, kp),
                       flash_attention_fwd_ref(q, k, v, qp, kp))
    with pytest.raises(ValueError, match="group"):
        K.flash_attention_fwd(q, k[:, :, :0], v, qp, kp)
    out, lse = K.flash_attention_fwd(q, k, v, qp, kp, return_lse=True)
    assert torch.equal(out, flash_attention_fwd_ref(q, k, v, qp, kp))
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(K.attention(*leaves, qp, kp), leaves, g)
    want = flash_attention_bwd_ref(q, k, v, out, lse, g, qp, kp)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


# ------------------------------------------------- K6's launch plan (plan())
@pytest.mark.parametrize("sq,nh,kh,hd,sk", [
    (1, 24, 8, 128, 512), (1, 24, 8, 128, 4096), (16, 4, 2, 32, 256),
    (64, 2, 2, 64, 104), (2048, 24, 24, 128, 2048), (22, 6, 2, 128, 62)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_ignores_batch_and_positions(sq, nh, kh, hd, sk, dtype):
    """The plan is a function of (dtype, Sq, NH, KH, hd, Sk) alone: the
    wrapper's call for a batch of 8 and for its row 0 alone take the same
    path and split length, and neither B nor the positions is an argument,
    so row 0 computes the same alone and in the batch."""
    dt = getattr(torch, dtype)
    q = torch.zeros((8, sq, nh, hd), dtype=dt)
    k = torch.zeros((8, sk, kh, hd), dtype=dt)
    assert K.plan_of(q, k) == K.plan_of(q[:1], k[:1]) == K.plan(
        dt, sq, nh, kh, hd, sk)
    assert list(inspect.signature(K.plan).parameters) == [
        "dtype", "sq", "nh", "kh", "hd", "sk"]


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("rows", [1, 3, 63, 64, 65, 66, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_takes_the_mma_path_only_for_bf16_with_64_rows(hd, rows, dtype):
    """"mma" exactly for bfloat16 with Sq·G ≥ 64 and hd ∈ {64, 128};
    "split" otherwise (every float32 call, decode steps, small chunks,
    hd 256)."""
    for g in (1, 3):
        if rows % g:
            continue
        path, split_len = K.plan(getattr(torch, dtype), rows // g, 2 * g, 2,
                                 hd, 300)
        mma = dtype == "bfloat16" and rows >= 64 and hd in (64, 128)
        assert path == ("mma" if mma else "split")
        assert (split_len == 0) == mma


@pytest.mark.parametrize("sk", [0, 1, 63, 64, 65, 512, 513, 4095, 4096,
                                8192, 20000])
def test_split_count_covers_the_cache(sk):
    """Split count = ceil(Sk / split_len) (at least 1); a decode step's
    split_len is a multiple of the 32-key tile within [SPLIT_LEN,
    MAX_SPLIT_LEN] = [64, 1024]."""
    path, split_len = K.plan(torch.bfloat16, 1, 24, 8, 128, sk)
    assert path == "split"
    assert split_len % 32 == 0 and 64 <= split_len <= 1024
    n = K.n_splits(sk, split_len)
    assert n == max(1, math.ceil(sk / split_len))
    assert (n - 1) * split_len < max(sk, 1) <= n * split_len
    assert K.n_splits(sk, 0) == 1                      # the MMA path


@pytest.mark.parametrize("sq,nh,kh,hd,sk", [
    (6, 24, 8, 128, 4096), (17, 2, 2, 64, 300), (64, 4, 4, 32, 2048),
    (2048, 24, 24, 128, 2048), (512, 24, 24, 128, 32768), (9, 6, 2, 128, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_takes_one_split_past_one_row_block(sq, nh, kh, hd, sk, dtype):
    """A split-path call with more than SPLIT_ROWS (16) rows already has
    a block per row chunk: one split of whole tiles covers the cache, so
    the scratch is about the output's size, whatever Sk."""
    path, split_len = K.plan(getattr(torch, dtype), sq, nh, kh, hd, sk)
    if path == "mma":
        assert dtype == "bfloat16" and sq * nh // kh >= 64
        return
    assert sq * nh // kh > K.SPLIT_ROWS
    assert split_len % K.TILE_KEYS == 0 and split_len >= max(sk, 1)
    assert split_len - K.TILE_KEYS < max(sk, 1)
    assert K.n_splits(sk, split_len) == 1
