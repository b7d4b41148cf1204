"""The Matérn-5/2 gram of the GP fit: the port's plain versions of the CUDA
kernels K3 (``matern52_gram_fwd``) and K4 (``matern52_gram_bwd_theta``) and
its autograd op against the JAX package (``matern52_gram_ref``, the Pallas
``matern52_gram`` in interpret mode, ``jax.vmap`` of ``gp.kernels.gram``,
``jax.vjp`` in θ), on the CPU, in float64, from numpy inputs.  The kernels
themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.gp import kernels as jk  # noqa: E402
from repro.kernels.matern.kernel import matern52_gram as j_gram_pallas  # noqa: E402,E501
from repro.kernels.matern.ref import matern52_gram_ref as j_gram_ref  # noqa: E402,E501
from repro_torch.gp import kernels as tk  # noqa: E402
from repro_torch.gp.fit import _FAR  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ops import (matern52_cross,  # noqa: E402
                                            matern52_gram_op)
from repro_torch.kernels.matern.ref import (  # noqa: E402
    SQRT5, matern52_gram_bwd_theta_ref, matern52_gram_ref)

SHAPES = [(7, 13, 5), (128, 128, 8), (130, 250, 40), (1, 257, 3)]


def t(a):
    return torch.tensor(np.array(a, np.float64))


def inputs(n1, n2, d, r=2, seed=0):
    rng = np.random.default_rng(seed + n1 * 7 + d)
    x1 = rng.standard_normal((n1, d))
    x2 = rng.standard_normal((n2, d))
    ils = np.exp(0.3 * rng.standard_normal((r, d)))
    amp = np.exp(0.5 * rng.standard_normal(r))
    return x1, x2, ils, amp


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def bwd_scales(x1, x2, ils, amp, g):
    """Σ|terms| of each sum K4 takes, so an error is judged against the
    sum's own condition: ((R, D), (R,))."""
    a = x1[None] * ils[:, None, :]
    b = x2[None] * ils[:, None, :]
    d2 = np.maximum(((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1), 0)
    r = np.sqrt(d2 + 1e-36)
    e = np.exp(-SQRT5 * r)
    c = np.abs(g) * (1 + SQRT5 * r) * e
    diff2 = (x1[:, None, :] - x2[None, :, :]) ** 2
    s_ils = (5 / 3) * amp[:, None] * ils * np.einsum("rij,ijd->rd", c, diff2)
    s_amp = (np.abs(g) * (1 + SQRT5 * r + 5 / 3 * d2) * e).sum((1, 2))
    return s_ils, s_amp


@pytest.mark.parametrize("n1,n2,d", SHAPES)
def test_plain_gram_matches_jax_ref_and_pallas(n1, n2, d):
    x1, x2, ils, amp = inputs(n1, n2, d, r=1)
    # batched plain version (one θ row) and the one-θ cross op
    k_t = matern52_gram_ref(t(x1), t(x2), t(ils), t(amp))[0]
    k_c = matern52_cross(t(x1), t(x2), t(ils[0]), t(amp[0]))
    k_j = j_gram_ref(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ils[0]),
                     jnp.asarray(amp[0]))
    # same f64 formula, products summed in another order
    assert rel_err(k_t, k_j) <= 1e-13
    assert torch.equal(k_c, k_t)
    # the TPU kernel computes in f32: its own test's tolerance
    k_p = j_gram_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ils[0]),
                        jnp.asarray(amp[0]), interpret=True)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_p), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("kernel", ["matern52", "rbf"])
def test_batched_theta_gram_matches_vmap(kernel):
    rng = np.random.default_rng(1)
    n, d, r = 33, 4, 3
    x = rng.uniform(0, 1, (n, d))
    ll = rng.uniform(-1.0, 0.5, (r, d))
    la, ln = rng.uniform(-0.5, 0.5, r), rng.uniform(-6, -3, r)
    g_j = jax.vmap(lambda p: jk.gram(jnp.asarray(x), p, kernel))(
        jk.KernelParams(jnp.asarray(ll), jnp.asarray(la), jnp.asarray(ln)))
    g_t = tk.gram(t(x), tk.KernelParams(t(ll), t(la), t(ln)), kernel)
    assert g_t.shape == (r, n, n)
    assert rel_err(g_t, g_j) <= 1e-13
    # each θ row is the unbatched gram at that row
    for i in range(r):
        g_i = tk.gram(t(x), tk.KernelParams(t(ll[i]), t(la[i]), t(ln[i])),
                      kernel)
        assert rel_err(g_t[i], g_i) <= 1e-14


@pytest.mark.parametrize("n1,n2,d", [(7, 13, 5), (40, 40, 3), (1, 70, 8)])
def test_bwd_theta_ref_matches_jax_vjp(n1, n2, d):
    x1, x2, ils, amp = inputs(n1, n2, d, r=2, seed=3)
    g = np.random.default_rng(4).standard_normal((2, n1, n2))

    def j_fn(il, a):
        return jax.vmap(lambda i, s: j_gram_ref(jnp.asarray(x1),
                                                jnp.asarray(x2), i, s))(il, a)

    _, vjp = jax.vjp(j_fn, jnp.asarray(ils), jnp.asarray(amp))
    d_il_j, d_amp_j = vjp(jnp.asarray(g))
    d_il_t, d_amp_t = matern52_gram_bwd_theta_ref(t(x1), t(x2), t(ils),
                                                  t(amp), t(g))
    s_il, s_amp = bwd_scales(x1, x2, ils, amp, g)
    assert np.all(np.abs(d_il_t.numpy() - np.asarray(d_il_j)) <= 1e-10 * s_il)
    assert np.all(np.abs(d_amp_t.numpy() - np.asarray(d_amp_j))
                  <= 1e-10 * s_amp)


def test_gram_op_gradient_is_autograds_through_plain_gram():
    rng = np.random.default_rng(5)
    n, d, r = 24, 3, 2
    x = t(rng.uniform(0, 1, (n, d)))
    theta = t(np.concatenate([rng.uniform(-1, 0.5, (r, d)),
                              rng.uniform(-0.5, 0.5, (r, 1)),
                              rng.uniform(-6, -3, (r, 1))], 1))
    g = t(rng.standard_normal((r, n, n)))

    def grads(kfn):
        th = theta.clone().requires_grad_(True)
        p = tk.KernelParams(th[:, :d], th[:, d], th[:, d + 1])
        k = kfn(x, x, p)
        (k * g).sum().backward()
        return th.grad

    def through_op(x1, x2, p):
        k = matern52_gram_op(x1, x2, torch.exp(-p.log_lengthscale),
                             p.amplitude)
        return k + 0.0 * p.log_noise[:, None, None]

    K.reset_launch_counts()
    g_op, g_plain = grads(through_op), grads(tk.matern52_plain)
    il = np.exp(-theta[:, :d].numpy())
    s_il, s_amp = bwd_scales(x.numpy(), x.numpy(), il,
                             np.exp(theta[:, d].numpy()), g.numpy())
    # chain rule through exp(−log ℓ) and exp(log σ_f²)
    assert np.all(np.abs((g_op - g_plain)[:, :d].numpy()) <= 1e-10 * il * s_il)
    assert np.all(np.abs((g_op - g_plain)[:, d].numpy())
                  <= 1e-10 * s_amp * np.exp(theta[:, d].numpy()))
    # CPU tensors take the plain versions: nothing was launched or built
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    assert _build._LIB is None
    # x takes no gradient through the op
    with pytest.raises(ValueError, match="must not require grad"):
        matern52_gram_op(x.clone().requires_grad_(True), x,
                         torch.exp(-theta[:, :d]), torch.exp(theta[:, d]))


@pytest.mark.parametrize("log_ls", [-4.0, 0.0, 4.0])
def test_values_and_gradients_finite_with_far_rows(log_ls):
    """Padded _FAR pseudo-rows (x ≈ 1e6 + i) with ℓ down to e⁻⁴: d² ~ 1e16
    and its cancellation between two such rows stay finite, so the masked
    LML's 0·k never meets a NaN."""
    rng = np.random.default_rng(6)
    n, m, d = 20, 12, 6
    x = np.concatenate([rng.uniform(0, 1, (n - m, d)),
                        _FAR + np.arange(m)[:, None] + np.zeros((m, d))])
    ils = np.full((2, d), np.exp(-log_ls))
    ils[1] *= np.exp(rng.uniform(-0.5, 0.5, d))
    amp = np.array([1.3, 0.2])
    k = matern52_gram_ref(t(x), t(x), t(ils), t(amp))
    g = t(rng.standard_normal((2, n, n)))
    d_il, d_amp = matern52_gram_bwd_theta_ref(t(x), t(x), t(ils), t(amp), g)
    assert bool(torch.isfinite(k).all())
    assert bool(torch.isfinite(d_il).all() and torch.isfinite(d_amp).all())
    # a real row against a _FAR row underflows to exactly 0
    assert float(k[:, : n - m, n - m:].abs().max()) == 0.0
    # the fit's masked gradient: through log θ, with the mask applied
    v = t((np.arange(n) < n - m).astype(float))
    th = t(np.concatenate([np.full((2, d), log_ls), [[0.1, -4.0],
                                                     [0.3, -5.0]]], 1))
    th.requires_grad_(True)
    p = tk.KernelParams(th[:, :d], th[:, d], th[:, d + 1])
    kk = tk.gram(t(x), p) * (v[:, None] * v[None, :]) + torch.diag(1 - v)
    torch.linalg.cholesky(kk).diagonal(dim1=-2, dim2=-1).log().sum().backward()
    assert bool(torch.isfinite(th.grad).all())
