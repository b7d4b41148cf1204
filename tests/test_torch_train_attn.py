"""The attention's backward on the CPU (K7's plain version,
``kernels/flash/ref.py::flash_attention_bwd_ref``, through the autograd op
``kernels/flash/kernel.py::attention``) against ``jax.vjp`` of the JAX
package's ``attention_xla`` (what the reference trains through), float32,
within 1e-5 of each gradient's largest entry: causal, not causal, a local
window, GQA (G = 1, 3, 8) and Sq ≠ Sk (whisper's cross-attention, every
query at position 0, not causal); and against torch autograd through the
plain forward ``flash_attention_fwd_ref``.  The port's own plain
``layers.attention_xla`` (tests only: no path calls it) equals JAX's,
chunked or not, and keeps C9's rule (a query that sees no key gets the
mean of v).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import attention_xla as jax_attention_xla  # noqa: E402,E501
from repro_torch.kernels.flash import kernel as K  # noqa: E402
from repro_torch.kernels.flash.ref import (flash_attention_bwd_ref,  # noqa: E402,E501
                                           flash_attention_fwd_ref)
from repro_torch.models import layers as L  # noqa: E402

# (B, Sq, Sk, NH, KH, hd, causal, window (0 = none), query positions)
CASES = {
    "causal": (2, 24, 24, 4, 4, 32, True, 0, "self"),
    "not_causal": (2, 24, 24, 4, 4, 32, False, 0, "self"),
    "window": (2, 40, 40, 4, 2, 32, True, 7, "self"),
    "gqa3": (2, 20, 20, 6, 2, 64, True, 0, "self"),
    "gqa8": (1, 16, 16, 8, 1, 32, True, 0, "self"),
    "cross": (2, 12, 30, 4, 4, 32, False, 0, "zero"),
    "chunk_offset": (2, 16, 40, 4, 2, 32, True, 0, "suffix"),
}


def inputs(case, seed):
    b, sq, sk, nh, kh, hd, _, _, qpos = case
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, sq, nh, hd), (b, sk, kh, hd),
                             (b, sk, kh, hd), (b, sq, nh, hd)))
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    if qpos == "self":
        qp = kp[:, :sq].copy()
    elif qpos == "zero":
        qp = np.zeros((b, sq), np.int32)
    else:                       # a prefill chunk continuing a cache
        qp = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32),
                             (b, sq)).copy()
    return q, k, v, g, qp, kp


def rel_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(got.detach().double().numpy() - want).max() / max(
        np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_backward_matches_jax_grad_of_attention_xla(name):
    case = CASES[name]
    causal, window = case[6], case[7]
    q, k, v, g, qp, kp = inputs(case, 11)
    out, vjp = jax.vjp(lambda a, b_, c: jax_attention_xla(
        a, b_, c, causal=causal, window=window, q_pos=jnp.asarray(qp),
        kv_pos=jnp.asarray(kp)), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got_out = K.attention(*leaves, torch.from_numpy(qp),
                          torch.from_numpy(kp), causal=causal, window=window)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(g))
    assert rel_err(got_out, out) <= 1e-5
    for a, b_ in zip(got, want):
        assert rel_err(a, b_) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(name):
    case = CASES[name]
    causal, window = case[6], case[7] or None
    q, k, v, g, qp, kp = (torch.from_numpy(x) for x in inputs(case, 12))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention_fwd_ref(*leaves, qp, kp, causal=causal,
                                  window=window)
    want = torch.autograd.grad(out, leaves, g)
    o, lse = flash_attention_fwd_ref(q, k, v, qp, kp, causal=causal,
                                     window=window, return_lse=True)
    assert torch.equal(o, out.detach())
    got = flash_attention_bwd_ref(q, k, v, o, lse, g, qp, kp, causal=causal,
                                  window=window)
    for a, b_ in zip(got, want):
        assert rel_err(a, b_.numpy()) <= 1e-5


def test_rows_with_no_visible_key_get_lse_inf_and_zero_gradient():
    """The Pallas rule (window 0 with causal hides every key; K6's
    single-head entry): lse = +inf, the output 0, every gradient exactly
    0."""
    q, k, v, g, qp, kp = (torch.from_numpy(x)
                          for x in inputs(CASES["gqa3"], 13))
    o, lse = K.flash_attention_fwd(q, k, v, qp, kp, causal=True, window=0,
                                   return_lse=True)
    assert bool((lse == torch.inf).all()) and not o.any()
    for t in K.flash_attention_bwd(q, k, v, o, lse, g, qp, kp, causal=True,
                                   window=0):
        assert not t.any()


@pytest.mark.parametrize("chunk", [0, 8])
def test_port_attention_xla_equals_jax_with_c9_rows(chunk):
    """A decode-like call over a cache with empty slots (−1) and an idle
    query (position −1): the idle row gets the mean of v (C9), as JAX's."""
    q, k, v, _, qp, kp = inputs(CASES["chunk_offset"], 14)
    kp[:, -5:] = -1
    qp[1, 3] = -1
    want = jax_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=0, q_pos=jnp.asarray(qp),
                             kv_pos=jnp.asarray(kp), chunk=chunk)
    got = L.attention_xla(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True, window=0, q_pos=torch.from_numpy(qp),
                          kv_pos=torch.from_numpy(kp), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    vmean = torch.from_numpy(v[1]).mean(0).repeat_interleave(2, 0)
    torch.testing.assert_close(got[1, 3], vmean, atol=1e-6, rtol=1e-6)
