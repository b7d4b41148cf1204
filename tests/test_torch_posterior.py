"""The fused posterior: the port's plain versions (the CPU path of the CUDA
kernels) and its autograd op against the JAX package's f64 oracle
``repro.kernels.matern.ref`` and ``jax.grad`` of it; the engine's LogEI
backends against JAX's ``logei_acq``.  The kernels themselves are held
against the plain versions on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.acquisition import log_ei as j_log_ei  # noqa: E402
from repro.core.acquisition import logei_acq as j_logei_acq  # noqa: E402
from repro.gp import gpr as jgpr  # noqa: E402
from repro.gp.kernels import KernelParams as JParams  # noqa: E402
from repro.kernels.matern.ref import \
    matern52_posterior_ref as j_post_ref  # noqa: E402
from repro_torch.convert import gp_state_from_numpy  # noqa: E402
from repro_torch.core.acquisition import log_ei, logei_acq  # noqa: E402
from repro_torch.engine.posterior import (fused_logei_acq,  # noqa: E402
                                          posterior, resolve_backend)
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.kernels.matern.ops import \
    matern52_posterior_op  # noqa: E402
from repro_torch.kernels.matern.ref import (  # noqa: E402
    matern52_posterior_bwd_ref, matern52_posterior_fwd_ref,
    matern52_posterior_ref)

EPS64 = float(np.finfo(np.float64).eps)


def jax_state(n, d, seed, log_noise=-5.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    y = np.sin(5 * X).sum(1)
    y = (y - y.mean()) / y.std()
    p = JParams(jnp.asarray(rng.uniform(-1.2, 0.0, d)), jnp.asarray(0.2),
                jnp.asarray(log_noise))
    return jgpr.with_kinv(jgpr.fit_gram(jnp.asarray(X), jnp.asarray(y), p))


def to_port(gj, device="cpu"):
    return gp_state_from_numpy(
        x_train=np.asarray(gj.x_train), y_train=np.asarray(gj.y_train),
        log_lengthscale=np.asarray(gj.params.log_lengthscale),
        log_amplitude=np.asarray(gj.params.log_amplitude),
        log_noise=np.asarray(gj.params.log_noise),
        chol=np.asarray(gj.chol), alpha=np.asarray(gj.alpha),
        kinv=np.asarray(gj.kinv), device=device)


def j_args(gj):
    return (gj.x_train, gj.alpha, gj.kinv,
            jnp.exp(-gj.params.log_lengthscale), gj.params.amplitude)


def t_args(gt):
    return (gt.x_train, gt.alpha, gt.kinv,
            torch.exp(-gt.params.log_lengthscale), gt.params.amplitude)


@pytest.mark.parametrize("n,d,q", [(7, 3, 5), (50, 5, 33), (130, 8, 129)])
def test_posterior_ref_matches_jax_oracle(n, d, q):
    gj = jax_state(n, d, seed=n)
    gt = to_port(gj)
    xq = np.random.default_rng(q).uniform(0, 1, (q, d))
    m_j, v_j = j_post_ref(jnp.asarray(xq), *j_args(gj))
    m_t, v_t = matern52_posterior_ref(torch.tensor(xq), *t_args(gt))
    # mean: f64 sums in another order
    scale = float(np.max(np.abs(np.asarray(m_j))))
    assert float(np.max(np.abs(m_t.numpy() - np.asarray(m_j)))) \
        <= 1e-12 * scale
    # var = σ_f² − k*K⁻¹k*ᵀ cancels: its rounding error grows with ‖K⁻¹‖
    amp = float(gj.params.amplitude)
    tol = 8 * n * EPS64 * amp * amp * float(np.max(np.abs(gj.kinv)))
    assert float(np.max(np.abs(v_t.numpy() - np.asarray(v_j)))) <= tol
    # the forward's residual t = k* K⁻¹ is what the backward reads
    _, _, t_res = matern52_posterior_fwd_ref(torch.tensor(xq), *t_args(gt))
    k = K.matern52_posterior_fwd(torch.tensor(xq), *t_args(gt))[2]
    assert torch.equal(t_res, k)


def _readouts():
    def linear_j(m, v):
        return jnp.sum(m) + jnp.sum(v)

    def logei_j(m, v):
        return jnp.sum(j_log_ei(m, v, 0.8))

    def linear_t(m, v):
        return m.sum() + v.sum()

    def logei_t(m, v):
        return log_ei(m, v, 0.8).sum()
    return {"linear": (linear_j, linear_t), "logei": (logei_j, logei_t)}


@pytest.mark.parametrize("readout", ["linear", "logei"])
def test_posterior_gradient_matches_jax_grad(readout):
    rj, rt = _readouts()[readout]
    # noise e⁻² keeps var ≫ its rounding error, so the LogEI readout's
    # cotangents (∝ 1/var) agree between the packages to ~1e-13
    gj = jax_state(40, 4, seed=9, log_noise=-2.0)
    gt = to_port(gj)
    xq = np.random.default_rng(9).uniform(0, 1, (9, 4))
    if readout == "linear":
        # a query on a training point: r = 0, where d2 is clamped.  (The
        # nonlinear readout would amplify the two packages' last-ulp
        # variance differences there through 1/σ, so it stays off it.)
        xq[0] = np.asarray(gj.x_train[3])
    g_j = jax.grad(lambda z: rj(*j_post_ref(z, *j_args(gj))))(
        jnp.asarray(xq))
    # autograd through the op (CPU: the plain versions of K1 and K2)
    x = torch.tensor(xq, requires_grad=True)
    (g_op,) = torch.autograd.grad(rt(*matern52_posterior_op(x,
                                                            *t_args(gt))), x)
    np.testing.assert_allclose(g_op.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-12)
    # the closed form directly, from the cotangents of the readout
    x2 = torch.tensor(xq)
    m, v, t = matern52_posterior_fwd_ref(x2, *t_args(gt))
    mm, vv = m.clone().requires_grad_(True), v.clone().requires_grad_(True)
    g_m, g_v = torch.autograd.grad(rt(mm, vv), (mm, vv))
    xt, alpha, _, ils, amp = t_args(gt)
    g_bwd = matern52_posterior_bwd_ref(x2, xt, alpha, t, v, ils, amp,
                                       g_m, g_v)
    np.testing.assert_allclose(g_bwd.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_logei_values_and_gradients_match_jax(backend):
    gj = jax_state(50, 4, seed=3)
    gt = to_port(gj)
    xq = np.random.default_rng(4).uniform(0, 1, (12, 4))
    # an incumbent far above the data puts z ≤ −25 (asymptotic branch)
    # at every query; queries away from the data keep σ well conditioned
    best = float(np.max(np.asarray(gj.y_train))) + 30.0

    def jf(z):
        return j_logei_acq((gj, jnp.asarray(best)), z)
    a_j = np.asarray(jf(jnp.asarray(xq)))
    g_j = np.asarray(jax.grad(lambda z: jnp.sum(jf(z)))(jnp.asarray(xq)))
    acq = logei_acq if backend == "cholesky" else fused_logei_acq("fused")
    x = torch.tensor(xq, requires_grad=True)
    a_t = acq((gt, torch.tensor(best, dtype=torch.float64)), x)
    (g_t,) = torch.autograd.grad(a_t.sum(), x)
    m, v = posterior(gt, torch.tensor(xq), backend="cholesky")
    z = (m - best) / torch.sqrt(v)
    assert float(z.min()) <= -25.0            # asymptotic branch covered
    assert bool(torch.isfinite(g_t).all())
    # the quadratic-form variance differs from the Cholesky one by
    # ~n·eps·‖K⁻¹‖ (absolute); LogEI ≈ −z²/2 carries that as a relative
    # error of var into its value and gradient
    np.testing.assert_allclose(a_t.detach().numpy(), a_j, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-9, atol=1e-12)


def test_fused_needs_kinv_and_auto_resolves_by_device():
    gj = jax_state(20, 3, seed=1)
    gt = to_port(gj)
    gt.kinv = None
    x = torch.rand(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="kinv"):
        posterior(gt, x, backend="fused")
    m, v = posterior(gt, x, backend="auto")     # CPU: Cholesky
    assert m.shape == (4,) and v.shape == (4,)
    assert resolve_backend("auto", "cpu") == "cholesky"
    assert resolve_backend("auto", "cuda") == "fused"
    with pytest.raises(ValueError):
        resolve_backend("pallas")


def test_cpu_tensors_take_plain_versions_without_launches():
    gj = jax_state(20, 3, seed=2)
    gt = to_port(gj)
    x = torch.rand(5, 3, dtype=torch.float64, requires_grad=True)
    K.reset_launch_counts()
    m, v = matern52_posterior_op(x, *t_args(gt))
    (m.sum() + v.sum()).backward()
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    assert K._LIB is None                     # nothing was built or loaded
    # a device with no kernel raises rather than falling back
    with pytest.raises(ValueError, match="no kernel"):
        K.matern52_posterior_fwd(*(a.to("meta") for a in
                                   (x.detach(),) + t_args(gt)))
    # the op differentiates in xq only
    ls = gt.params.log_lengthscale.clone().requires_grad_(True)
    m, v = matern52_posterior_op(x.detach(), gt.x_train, gt.alpha, gt.kinv,
                                 torch.exp(-ls), gt.params.amplitude)
    with pytest.raises(NotImplementedError):
        m.sum().backward()
