"""Parity of the port's BO numerics that no suggest path calls yet with the
JAX package, on the CPU, from the same numpy inputs: the joint posterior
(``gp/gpr.py::predict_joint``), the acquisition closures and the joint
q-batch qLogEI (``core/acquisition.py``, with the reference's Monte Carlo
draws injected), the dense inverse Hessian, dense BFGS and the batched
value-and-gradient lift (``core/lbfgsb.py``), the closure API and the
default engine (``core/mso.py``, ``engine/engine.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import acquisition as jacq  # noqa: E402
from repro.core import lbfgsb as jl  # noqa: E402
from repro.gp import gpr as jgpr  # noqa: E402
from repro.gp import kernels as jk  # noqa: E402
from repro_torch.core import acquisition as tacq  # noqa: E402
from repro_torch.core import lbfgsb as tl  # noqa: E402
from repro_torch.core.mso import (MsoOptions, closure_engine,  # noqa: E402
                                  maximize_acqf, maximize_acqf_closure)
from repro_torch.engine.engine import EvalEngine, default_engine  # noqa: E402
from repro_torch.gp import gpr as tgpr  # noqa: E402
from repro_torch.gp import kernels as tk  # noqa: E402


def t(a):
    return torch.tensor(np.array(a, np.float64))


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def gps():
    """One GP fitted at fixed θ in both packages (n=40, D=4, noisy y)."""
    rng = np.random.default_rng(0)
    n, d = 40, 4
    X = rng.uniform(0, 1, (n, d))
    y = np.sin(6 * X).sum(1) + 0.05 * rng.standard_normal(n)
    y = (y - y.mean()) / y.std()
    ll = rng.uniform(-1.0, 0.5, d)
    jp = jk.KernelParams(jnp.asarray(ll), jnp.asarray(0.3),
                         jnp.asarray(-4.5))
    tp = tk.KernelParams(t(ll), t(0.3), t(-4.5))
    gj = jgpr.fit_gram(jnp.asarray(X), jnp.asarray(y), jp)
    gt = tgpr.fit_gram(t(X), t(y), tp)
    return gj, gt, float(y.max()), rng


def test_predict_joint_matches_jax(gps):
    gj, gt, _, rng = gps
    xq = rng.uniform(0, 1, (3, 4))
    m_j, c_j = jgpr.predict_joint(gj, jnp.asarray(xq))
    m_t, c_t = tgpr.predict_joint(gt, t(xq))
    assert c_t.shape == (3, 3)
    assert rel_err(m_t, m_j) <= 1e-12
    assert rel_err(c_t, c_j) <= 1e-12
    # the diagonal is predict's variance (up to the jitter)
    _, v = tgpr.predict(gt, t(xq))
    np.testing.assert_allclose(torch.diagonal(c_t).numpy(), v.numpy(),
                               rtol=0, atol=1e-9)


def test_predict_joint_stacked_is_each_study():
    """A stacked state (leading S) gives each study's joint posterior,
    bitwise the study alone."""
    rng = np.random.default_rng(1)
    S, n, d = 3, 12, 2
    gps = []
    for s in range(S):
        p = tk.KernelParams(t(rng.uniform(-1, 0, d)), t(0.1 * s), t(-3.0))
        gps.append(tgpr.fit_gram(t(rng.uniform(0, 1, (n, d))),
                                 t(rng.standard_normal(n)), p))
    stack = tgpr.GPState(
        x_train=torch.stack([g.x_train for g in gps]),
        y_train=torch.stack([g.y_train for g in gps]),
        params=tk.KernelParams(*(torch.stack([getattr(g.params, f)
                                              for g in gps])
                                 for f in ("log_lengthscale",
                                           "log_amplitude", "log_noise"))),
        chol=torch.stack([g.chol for g in gps]),
        alpha=torch.stack([g.alpha for g in gps]))
    xq = t(rng.uniform(0, 1, (S, 4, d)))
    m, c = tgpr.predict_joint(stack, xq)
    assert m.shape == (S, 4) and c.shape == (S, 4, 4)
    for s in range(S):
        m1, c1 = tgpr.predict_joint(gps[s], xq[s])
        assert torch.equal(m[s], m1) and torch.equal(c[s], c1)


def test_make_logei_and_make_ucb_match_jax(gps):
    gj, gt, best, rng = gps
    xb = rng.uniform(0, 1, (7, 4))
    for jf, tf in ((jacq.make_logei(gj, best), tacq.make_logei(gt, best)),
                   (jacq.make_ucb(gj), tacq.make_ucb(gt)),
                   (jacq.make_ucb(gj, 0.5), tacq.make_ucb(gt, 0.5))):
        assert rel_err(tf(t(xb)), jf(jnp.asarray(xb))) <= 1e-12


def test_qlogei_and_its_gradient_match_jax_with_injected_draws(gps):
    gj, gt, best, rng = gps
    q = 3
    sj = jacq.qlogei_state(gj, best, q, n_samples=32, seed=4)
    # torch cannot reproduce threefry: the reference's draws go in as eps
    st = (gt, torch.tensor(best, dtype=torch.float64), t(sj[2]))
    xb = rng.uniform(0, 1, (5, q, 4))
    vj, gj_ = jax.value_and_grad(
        lambda x: jnp.sum(jacq.qlogei_acq(sj, x)))(jnp.asarray(xb))
    fj = jacq.qlogei_acq(sj, jnp.asarray(xb))
    x = t(xb).requires_grad_(True)
    ft = tacq.qlogei_acq(st, x)
    (gt_,) = torch.autograd.grad(ft.sum(), x)
    assert ft.shape == (5,)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=0,
                               atol=1e-10)
    # the port's own state: eps from a torch.Generator, (S, q), seeded
    g2, b2, eps = tacq.qlogei_state(gt, best, q, n_samples=16, seed=4)
    assert eps.shape == (16, q) and g2 is gt and b2.dtype == torch.float64
    assert torch.equal(eps, tacq.qlogei_state(gt, best, q, n_samples=16,
                                              seed=4)[2])


def _quad_j(x):
    return jnp.sum((x - 0.3) ** 2 * jnp.arange(1, x.shape[0] + 1))


def _quad_t(x):
    return ((x - 0.3) ** 2 * torch.arange(1, x.shape[0] + 1,
                                          dtype=x.dtype)).sum()


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_t(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def test_make_batched_value_and_grad_matches_jax():
    xb = np.random.default_rng(2).uniform(0, 3, (6, 5))
    for fj, ft in ((_rosen_j, _rosen_t), (_quad_j, _quad_t)):
        vj, gj = jl.make_batched_value_and_grad(fj)(jnp.asarray(xb))
        vt, gt = tl.make_batched_value_and_grad(ft)(t(xb))
        assert rel_err(vt, vj) <= 1e-12 and rel_err(gt, gj) <= 1e-12


def test_inv_hessian_dense_matches_jax_and_is_per_restart():
    """The two packages' materialized inverse Hessians agree, and each is
    per restart (the block structure of tests/test_lbfgsb.py:96)."""
    B, D = 2, 3
    x0 = np.array([[2.0, 1.0, 0.5], [-2.0, 1.5, -1.0]])
    jo = jl.LbfgsbOptions(maxiter=50, pgtol=1e-10, ftol=0.0)
    to = tl.LbfgsbOptions(maxiter=50, pgtol=1e-10, ftol=0.0)
    rj = jl.lbfgsb_minimize(jl.make_batched_value_and_grad(_quad_j),
                            jnp.asarray(x0), -10.0, 10.0, jo)
    rt = tl.lbfgsb_minimize(tl.make_batched_value_and_grad(_quad_t),
                            t(x0), -10.0, 10.0, to)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    Hj = np.asarray(jl.inv_hessian_dense(rj.state, 10))
    Ht = tl.inv_hessian_dense(rt.state, 10)
    assert Ht.shape == (B, D, D)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0, atol=1e-12)
    true_h = np.diag(1.0 / (2.0 * np.arange(1, D + 1)))
    for b in range(B):
        rel = np.linalg.norm(Ht[b].numpy() - true_h) / \
            np.linalg.norm(true_h)
        assert rel < 0.35, (b, rel)
        # row b's H is its own history's: the solve of row b alone
        one = tl.lbfgsb_minimize(tl.make_batched_value_and_grad(_quad_t),
                                 t(x0[b:b + 1]), -10.0, 10.0, to)
        np.testing.assert_allclose(
            tl.inv_hessian_dense(one.state, 10)[0].numpy(), Ht[b].numpy(),
            rtol=0, atol=1e-12)
    # column j is the two-loop recursion applied to e_j
    s_ord, y_ord, rho_ord, valid = tl._ordered_history(rt.state, 10)
    for j in range(D):
        e = torch.zeros((B, D), dtype=torch.float64)
        e[:, j] = 1.0
        col = tl.two_loop_direction(e, s_ord, y_ord, rho_ord, valid,
                                    rt.state.gamma)
        np.testing.assert_allclose(Ht[:, :, j].numpy(), col.numpy(),
                                   rtol=0, atol=1e-12)


def test_bfgs_minimize_matches_jax_on_batched_rosenbrock():
    x0 = np.random.default_rng(2).uniform(0.5, 1.5, (4, 4))
    rj = jl.bfgs_minimize(jl.make_batched_value_and_grad(_rosen_j),
                          jnp.asarray(x0), maxiter=300, gtol=1e-9)
    rt = tl.bfgs_minimize(tl.make_batched_value_and_grad(_rosen_t), t(x0),
                          maxiter=300, gtol=1e-9)
    assert isinstance(rt, tl.BfgsState) and rt.hinv.shape == (4, 4, 4)
    np.testing.assert_array_equal(rt.k.numpy(), np.asarray(rj.k))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    assert np.all(rt.f.numpy() < 1e-10)


def test_lbfgsb_minimize_jit_is_the_solve():
    xb = t(np.full((2, 3), 2.0))
    fb = tl.make_batched_value_and_grad(_quad_t)
    opts = tl.LbfgsbOptions(maxiter=50, pgtol=1e-9, ftol=0.0)
    a = tl.lbfgsb_minimize_jit(fb, xb, -5.0, 5.0, opts)
    b = tl.lbfgsb_minimize(fb, xb, -5.0, 5.0, opts)
    assert torch.equal(a.x, b.x) and torch.equal(a.k, b.k)


def _bowl(X):
    return -((X - 0.5) ** 2).sum(-1)


def test_closure_api():
    """Twin of tests/test_mso.py:79."""
    x0 = np.random.default_rng(1).uniform(0, 1, (4, 3))
    res = maximize_acqf_closure(_bowl, x0, 0.0, 1.0, strategy="dbe_vec",
                                options=MsoOptions(maxiter=50, pgtol=1e-8),
                                engine=closure_engine(_bowl, "cpu"))
    np.testing.assert_allclose(res.best_x, 0.5, atol=1e-5)


def test_closure_api_forwards_engine():
    """Twin of tests/test_mso.py:87: one engine serves every call; an
    engine built from a different closure is rejected."""
    eng = closure_engine(_bowl, "cpu")
    rng = np.random.default_rng(1)
    opts = MsoOptions(maxiter=50, pgtol=1e-8)
    for _ in range(3):
        res = maximize_acqf_closure(_bowl, rng.uniform(0, 1, (4, 3)), 0.0,
                                    1.0, strategy="dbe_vec", options=opts,
                                    engine=eng)
        np.testing.assert_allclose(res.best_x, 0.5, atol=1e-5)
    assert eng.n_compiles == 1      # one lockstep program, shared by 3 calls
    assert res.engine_stats["n_compiles"] == 1

    def other(X):
        return -(X ** 2).sum(-1)
    with pytest.raises(ValueError, match="different closure"):
        maximize_acqf_closure(other, rng.uniform(0, 1, (4, 3)), 0.0, 1.0,
                              strategy="dbe_vec", options=opts, engine=eng)


def _neg_bowl(state, X):
    del state
    return _bowl(X)


@pytest.mark.parametrize("strategy", ["dbe", "dbe_vec"])
def test_maximize_acqf_without_state_tensors(strategy):
    """C15: a state with no tensor (None) takes an engine for the
    function: given, or the process-wide default engine on a device."""
    x0 = np.random.default_rng(3).uniform(0, 1, (4, 3))
    opts = MsoOptions(maxiter=50, pgtol=1e-8)
    a = maximize_acqf(_neg_bowl, x0, 0.0, 1.0, acq_state=None,
                      strategy=strategy, options=opts,
                      engine=EvalEngine(_neg_bowl, "cpu"))
    eng = default_engine(_neg_bowl, "cpu")
    assert eng is default_engine(_neg_bowl, "cpu")
    assert eng.device == torch.device("cpu")
    b = maximize_acqf(_neg_bowl, x0, 0.0, 1.0, acq_state=None,
                      strategy=strategy, options=opts, engine=eng)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_allclose(a.best_x, 0.5, atol=1e-5)
    if not torch.cuda.is_available():
        # the default engine's device is the card: asked for without one,
        # it says how to run on the CPU instead of moving there
        with pytest.raises(RuntimeError, match="device='cpu'"):
            maximize_acqf(_neg_bowl, x0, 0.0, 1.0, acq_state=None,
                          strategy=strategy, options=opts)
