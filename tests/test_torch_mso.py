"""The port's MSO strategies against the JAX package on one fitted GP, and
the paper's claims (C3: D-BE reproduces SEQ per restart; C2: C-BE inflates
QN iterations; D-BE needs far fewer evaluation rounds) within the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.acquisition import logei_acq as j_logei_acq  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.core.mso import maximize_acqf as j_maximize  # noqa: E402
from repro.gp.fit import fit_gp as j_fit_gp  # noqa: E402
from repro.gp.gpr import with_kinv as j_with_kinv  # noqa: E402
from repro.core.acquisition import log_ei as j_log_ei  # noqa: E402
from repro.kernels.matern.ref import \
    matern52_posterior_ref as j_post_ref  # noqa: E402
from repro_torch.convert import gp_state_from_numpy  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.mso import MsoOptions, maximize_acqf  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.posterior import fused_logei_acq  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    n, d = 30, 3
    X = rng.uniform(0, 1, (n, d))
    # observation noise keeps the fitted σ_n² (and so ‖K⁻¹‖) moderate
    y = -np.sum((X - 0.3) ** 2, 1) + 0.2 * np.sin(9 * X[:, 0]) + \
        0.05 * rng.standard_normal(n)
    y_std = (y - y.mean()) / y.std()
    gj = j_with_kinv(j_fit_gp(jnp.asarray(X), jnp.asarray(y_std), seed=1,
                              pad_bucket=32))
    gt = gp_state_from_numpy(
        x_train=np.asarray(gj.x_train), y_train=np.asarray(gj.y_train),
        log_lengthscale=np.asarray(gj.params.log_lengthscale),
        log_amplitude=np.asarray(gj.params.log_amplitude),
        log_noise=np.asarray(gj.params.log_noise),
        chol=np.asarray(gj.chol), alpha=np.asarray(gj.alpha),
        kinv=np.asarray(gj.kinv))
    best = float(np.max(y_std))
    # random starts: at the incumbent (a training point) the posterior
    # variance is ~σ_n² and the quadratic form's cancellation, amplified
    # through LogEI's 1/σ, would make the compared trajectories drift
    x0 = rng.uniform(0, 1, (6, d))
    return gj, gt, best, x0


OPTS = dict(maxiter=100, pgtol=1e-5)


def j_quadform_logei_acq(state, X):
    """The reference's LogEI over its f64 quadratic-form posterior oracle:
    the JAX counterpart of the port's "fused" backend."""
    gp, best = state
    m, v = j_post_ref(X, gp.x_train, gp.alpha, gp.kinv,
                      jnp.exp(-gp.params.log_lengthscale),
                      gp.params.amplitude)
    return j_log_ei(m, v, best)


@pytest.mark.parametrize("strategy", ["seq", "cbe", "dbe"])
@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_strategies_match_jax(fitted, strategy, backend):
    gj, gt, best, x0 = fitted
    j_acq = j_logei_acq if backend == "cholesky" else j_quadform_logei_acq
    rj = j_maximize(j_acq, x0, 0.0, 1.0,
                    acq_state=(gj, jnp.asarray(best)), strategy=strategy,
                    options=JOpts(**OPTS))
    acq = logei_acq if backend == "cholesky" else fused_logei_acq("fused")
    rt = maximize_acqf(acq, x0, 0.0, 1.0,
                       acq_state=(gt, torch.tensor(best, dtype=torch.float64)),
                       strategy=strategy, options=MsoOptions(**OPTS))
    # one scipy L-BFGS-B per restart on both sides, fed values that agree
    # to ~1e-13: the trajectories agree to well under pgtol
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
    assert abs(rt.best_acq - rj.best_acq) <= 1e-9
    assert rt.engine_stats["n_rounds"] == rt.n_rounds + (
        1 if strategy == "cbe" else 0)
    # CPU tensors take the plain versions: this engine launched no kernel
    assert rt.engine_stats["kernel_launches"] == dict.fromkeys(
        K.LAUNCHES, 0)


@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_dbe_vec_matches_jax(fitted, backend):
    """The lockstep solve on both sides: the same per-restart iterations,
    evaluations and rounds, and the same maximizers to 1e-10."""
    gj, gt, best, x0 = fitted
    j_acq = j_logei_acq if backend == "cholesky" else j_quadform_logei_acq
    rj = j_maximize(j_acq, x0, 0.0, 1.0,
                    acq_state=(gj, jnp.asarray(best)), strategy="dbe_vec",
                    options=JOpts(**OPTS))
    acq = logei_acq if backend == "cholesky" else fused_logei_acq("fused")
    engine = EvalEngine(acq, "cpu")
    rt = maximize_acqf(acq, x0, 0.0, 1.0,
                       acq_state=(gt, torch.tensor(best, dtype=torch.float64)),
                       strategy="dbe_vec", options=MsoOptions(**OPTS),
                       engine=engine)
    np.testing.assert_array_equal(rt.n_iters, np.asarray(rj.n_iters))
    np.testing.assert_array_equal(rt.n_evals, np.asarray(rj.n_evals))
    assert rt.n_rounds == rj.n_rounds and rt.strategy == "dbe_vec"
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-10)
    assert abs(rt.best_acq - rj.best_acq) <= 1e-12
    st = rt.engine_stats
    assert st["n_rounds"] == rt.n_rounds
    assert st["n_points"] == int(np.sum(rt.n_evals))
    assert st["n_lockstep_compiles"] == 1 and st["n_compiles"] == 1
    # a second solve at the same shapes is no new program
    maximize_acqf(acq, x0, 0.0, 1.0, acq_state=(gt, torch.tensor(
        best, dtype=torch.float64)), strategy="dbe_vec",
        options=MsoOptions(**OPTS), engine=engine)
    assert engine.stats_snapshot()["retraces"]["causes"] == {
        "first-trace": 1}


def _c3(gt, best, x0, backend):
    acq = logei_acq if backend == "cholesky" else fused_logei_acq("fused")
    state = (gt, torch.tensor(best, dtype=torch.float64))
    seq = maximize_acqf(acq, x0, 0.0, 1.0, acq_state=state, strategy="seq",
                        options=MsoOptions(**OPTS))
    dbe = maximize_acqf(acq, x0, 0.0, 1.0, acq_state=state, strategy="dbe",
                        options=MsoOptions(**OPTS))
    np.testing.assert_array_equal(seq.n_iters, dbe.n_iters)
    np.testing.assert_array_equal(seq.n_evals, dbe.n_evals)
    assert dbe.n_rounds * 3 <= seq.n_rounds
    assert int(np.sum(dbe.n_evals)) == int(np.sum(seq.n_evals))
    return seq, dbe


@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_c3_dbe_reproduces_seq_within_port(fitted, backend):
    """On the CPU the matmul/solve may pick another path for another batch
    width, so last-ulp differences remain (bitwise on the card, where the
    kernels' sums do not depend on batch width: tests/test_torch_cuda.py).
    """
    _, gt, best, x0 = fitted
    seq, dbe = _c3(gt, best, x0, backend)
    assert float(np.max(np.abs(seq.x - dbe.x))) <= 1e-12


def neg_rosen_acq(state, X):
    del state
    return -(100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2
             + (1.0 - X[:, :-1]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def rosen():
    """The reference's Rosenbrock setup (tests/test_mso.py)."""
    x0 = np.random.default_rng(0).uniform(0, 3, (8, 5))
    opts = MsoOptions(m=10, maxiter=200, pgtol=1e-8)
    out = {}
    for s in ("seq", "cbe", "dbe"):
        out[s] = maximize_acqf(neg_rosen_acq, x0, 0.0, 3.0, strategy=s,
                               options=opts,
                               engine=EvalEngine(neg_rosen_acq, "cpu"))
    return out


def test_paper_claims_on_rosenbrock(rosen):
    seq, cbe, dbe = rosen["seq"], rosen["cbe"], rosen["dbe"]
    # C3: per-restart trajectories identical (elementwise objective, so
    # here even on the CPU the rows do not depend on batch width)
    np.testing.assert_array_equal(seq.x, dbe.x)
    np.testing.assert_array_equal(seq.n_iters, dbe.n_iters)
    # batching: ≥3× fewer rounds for the same evaluations
    assert dbe.n_rounds * 3 < seq.n_rounds
    assert int(np.sum(dbe.n_evals)) == int(np.sum(seq.n_evals))
    # C2: C-BE's shared dense QN state inflates iterations at B=8
    assert np.median(cbe.n_iters) > 2.0 * np.median(dbe.n_iters)
    for r in (seq, cbe, dbe):
        assert r.best_acq > -1e-6


def test_bad_inputs_raise():
    x0 = np.zeros((2, 3))
    with pytest.raises(ValueError, match="device"):
        maximize_acqf(neg_rosen_acq, x0, 0.0, 1.0, strategy="dbe_vec")
    with pytest.raises(ValueError, match="device"):
        maximize_acqf(neg_rosen_acq, x0, 0.0, 1.0, strategy="dbe")
    with pytest.raises(ValueError):
        maximize_acqf(neg_rosen_acq, x0, 0.0, 1.0, strategy="nope")
