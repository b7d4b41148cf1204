"""Parity of the port's GP layer (gp/kernels, gp/gpr, gp/fit, core/lbfgsb)
with the JAX package, on the CPU, from the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lbfgsb as jl  # noqa: E402
from repro.gp import fit as jfit  # noqa: E402
from repro.gp import gpr as jgpr  # noqa: E402
from repro.gp import kernels as jk  # noqa: E402
from repro_torch.core import lbfgsb as tl  # noqa: E402
from repro_torch.gp import fit as tfit  # noqa: E402
from repro_torch.gp import gpr as tgpr  # noqa: E402
from repro_torch.gp import kernels as tk  # noqa: E402

# both packages run the same f64 formulas; only summation order differs
# (XLA vs ATen reductions and LAPACK calls), a few ulp of the results
RTOL = 1e-12


def t(a):
    return torch.tensor(np.array(a, np.float64))


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def params_pair(rng, d):
    ll = rng.uniform(-1.0, 0.5, d)
    la, ln = 0.3, -4.5
    return (jk.KernelParams(jnp.asarray(ll), jnp.asarray(la),
                            jnp.asarray(ln)),
            tk.KernelParams(t(ll), t(la), t(ln)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 40, 4
    X = rng.uniform(0, 1, (n, d))
    y = np.sin(6 * X).sum(1)
    y = (y - y.mean()) / y.std()
    Xq = rng.uniform(0, 1, (9, d))
    jp, tp = params_pair(rng, d)
    return X, y, Xq, jp, tp


@pytest.mark.parametrize("kernel", ["matern52", "rbf"])
def test_kernels_and_gram_match_jax(data, kernel):
    X, y, Xq, jp, tp = data
    k_j = jk.KERNELS[kernel](jnp.asarray(Xq), jnp.asarray(X), jp)
    k_t = tk.KERNELS[kernel](t(Xq), t(X), tp)
    assert rel_err(k_t, k_j) <= RTOL
    g_j = jk.gram(jnp.asarray(X), jp, kernel)
    g_t = tk.gram(t(X), tp, kernel)
    assert rel_err(g_t, g_j) <= RTOL


def test_fit_gram_kinv_predict_match_jax(data):
    X, y, Xq, jp, tp = data
    gj = jgpr.with_kinv(jgpr.fit_gram(jnp.asarray(X), jnp.asarray(y), jp))
    gt = tgpr.with_kinv(tgpr.fit_gram(t(X), t(y), tp))
    for name in ("chol", "alpha"):
        assert rel_err(getattr(gt, name), getattr(gj, name)) <= RTOL, name
    # K⁻¹ amplifies the factor's last-ulp differences by cond(L)
    assert rel_err(gt.kinv, gj.kinv) <= 1e-10
    m_j, v_j = jgpr.predict(gj, jnp.asarray(Xq))
    m_t, v_t = tgpr.predict(gt, t(Xq))
    assert rel_err(m_t, m_j) <= RTOL
    assert rel_err(v_t, v_j) <= 1e-10      # σ_f² − |v|² cancels
    # padding keeps the posterior exact and extends K⁻¹ block-diagonally
    gp = tgpr.pad_gp(gt, 64)
    assert gp.x_train.shape[0] == 64 and gp.kinv.shape == (64, 64)
    m_p, v_p = tgpr.predict(gp, t(Xq))
    assert rel_err(m_p, m_t) <= RTOL and rel_err(v_p, v_t) <= 1e-10


def test_log_marginal_likelihood_masked_matches_jax(data):
    X, y, _, jp, tp = data
    valid = np.arange(40) < 33
    l_j = jgpr.log_marginal_likelihood_masked(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(valid), jp)
    l_t = tgpr.log_marginal_likelihood_masked(t(X), t(y), torch.as_tensor(
        valid), tp)
    assert abs(float(l_t) - float(l_j)) <= RTOL * abs(float(l_j))
    # the masked LML equals the exact LML of the valid subset
    l_sub = tgpr.log_marginal_likelihood(t(X[:33]), t(y[:33] * 1.0), tp)
    assert abs(float(l_t) - float(l_sub)) <= 1e-10 * abs(float(l_sub))


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                   + (1.0 - x[..., :-1]) ** 2, -1)


def _rosen_torch(x):
    return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
            + (1.0 - x[..., :-1]) ** 2).sum(-1)


def _vg_torch(fn):
    def vg(x):
        x = x.detach().requires_grad_(True)
        f = fn(x)
        (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g
    return vg


def _vg_jax(fn):
    import jax

    def vg(x):
        return fn(x), jax.grad(lambda z: jnp.sum(fn(z)))(x)
    return vg


def _quad_jax(x):
    c = jnp.linspace(0.1, 0.9, x.shape[-1])
    return jnp.sum((x - c) ** 2 * (1.0 + jnp.arange(x.shape[-1])), -1)


def _quad_torch(x):
    c = torch.linspace(0.1, 0.9, x.shape[-1], dtype=x.dtype)
    w = 1.0 + torch.arange(x.shape[-1], dtype=x.dtype)
    return ((x - c) ** 2 * w).sum(-1)


@pytest.mark.parametrize("problem,shape", [
    ("rosenbrock", (6, 4)), ("quadratic", (5, 3)),
    ("rosenbrock", (2, 3, 4)), ("quadratic", (2, 3, 5))])
def test_lbfgsb_matches_jax(problem, shape):
    fj, ft = {"rosenbrock": (_rosen_jax, _rosen_torch),
              "quadratic": (_quad_jax, _quad_torch)}[problem]
    x0 = np.random.default_rng(1).uniform(-0.5, 1.5, shape)
    opts = dict(m=6, maxiter=150, pgtol=1e-7, ftol=0.0)
    rj = jl.lbfgsb_minimize(_vg_jax(fj), jnp.asarray(x0), -0.4, 1.3,
                            jl.LbfgsbOptions(**opts))
    rt = tl.lbfgsb_minimize(_vg_torch(ft), t(x0), -0.4, 1.3,
                            tl.LbfgsbOptions(**opts))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.n_evals.numpy(),
                                  np.asarray(rj.n_evals))
    assert rt.rounds == int(rj.rounds)
    assert rt.x.shape == shape
    # same algorithm, reductions in another order: trajectories agree to
    # well below the convergence tolerance
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10)


def test_fit_gp_matches_jax_with_injected_theta_grid():
    rng = np.random.default_rng(2)
    n, d, R = 40, 4, 3
    X = rng.uniform(0, 1, (n, d))
    y = np.cos(5 * X).sum(1) + 0.1 * rng.standard_normal(n)
    y_std = (y - y.mean()) / y.std()
    thetas = np.asarray(jfit.theta_init_grid(d, jnp.float64, R, seed=5))
    gj = jfit.fit_gp(jnp.asarray(X), jnp.asarray(y_std), n_restarts=R,
                     seed=5, pad_bucket=32)
    gt = tfit.fit_gp(t(X), t(y_std), n_restarts=R, pad_bucket=32,
                     thetas=t(thetas))
    assert gt.x_train.shape == (64, d)
    # L-BFGS-B over the MAP objective amplifies last-ulp differences of
    # the two packages' Cholesky gradients into ~1e-8 differences in θ
    th_j = np.asarray(jfit.pack_theta(gj.params))
    th_t = tfit.pack_theta(gt.params).numpy()
    assert rel_err(th_t, th_j) <= 1e-6
    assert rel_err(gt.chol, gj.chol) <= 1e-6
    assert rel_err(gt.alpha, gj.alpha) <= 1e-6


def test_theta_init_grid_draws_and_standardize():
    g1 = tfit.theta_init_grid(3, torch.float64, 4, seed=9)
    g2 = tfit.theta_init_grid(3, torch.float64, 4, seed=9)
    assert g1.shape == (4, 5) and torch.equal(g1, g2)
    assert torch.equal(g1[0], t([0, 0, 0, 0, -4.0]))
    assert float((g1[1:] - g1[:1]).abs().max()) <= 1.0
    draws = np.full((3, 5), 0.25)
    g3 = tfit.theta_init_grid(3, torch.float64, 4, seed=9, draws=draws)
    assert torch.equal(g3[1:] - g3[:1], t(draws))
    with pytest.raises(ValueError):
        tfit.theta_init_grid(3, torch.float64, 4, seed=9, draws=draws[:2])
    y = np.random.default_rng(3).standard_normal(11)
    ys_j, _, _ = jfit.standardize(jnp.asarray(y))
    ys_t, _, _ = tfit.standardize(t(y))
    assert rel_err(ys_t, ys_j) <= RTOL
    valid = np.arange(16) < 11
    yp = np.concatenate([y, np.zeros(5)])
    ym_j, _, _ = jfit.standardize_masked(jnp.asarray(yp), jnp.asarray(valid))
    ym_t, _, _ = tfit.standardize_masked(t(yp), torch.as_tensor(valid))
    assert rel_err(ym_t, ym_j) <= RTOL
    assert float(ym_t[11:].abs().max()) == 0.0
