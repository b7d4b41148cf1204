"""The fused ask pipeline of the port (``engine/ask.py``, the rank-one GP
updates, ``GPSampler(strategy="dbe_vec")``), mirroring the reference's
``tests/test_ask.py`` inside the port, and held against the JAX package
from the same numpy inputs and injected random draws, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bo.sampler import GPSampler as JSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro.core.acquisition import logei_acq as j_logei_acq  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.engine import AskConfig as JAskConfig  # noqa: E402
from repro.engine import AskEngine as JAskEngine  # noqa: E402
from repro.engine import EvalEngine as JEvalEngine  # noqa: E402
from repro.gp import gpr as jgpr  # noqa: E402
from repro_torch.bo.sampler import GPSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.convert import ask_engine_from_numpy  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.engine.ask import AskConfig, AskEngine  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.posterior import fused_logei_acq  # noqa: E402
from repro_torch.gp import gpr as tgpr  # noqa: E402
from repro_torch.gp.fit import (_FAR, incremental_update,  # noqa: E402
                                standardize_masked)
from repro_torch.gp.kernels import gram, init_params  # noqa: E402
from repro_torch.kernels.matern import kernel as K  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402

D, B, N_STARTUP = 3, 6, 5


def _sphere(x):
    return float(np.sum((x - 0.4) ** 2))


def _sampler(fused, *, seed=3, refit_interval=8, warm_start=True, pad=16,
             backend="cholesky", **kw):
    return GPSampler(BoxSpace.cube(D, -1.0, 1.0), strategy="dbe_vec",
                     seed=seed, n_startup_trials=N_STARTUP, n_restarts=B,
                     fused=fused, refit_interval=refit_interval,
                     warm_start=warm_start, pad_multiple=pad,
                     posterior_backend=backend, device="cpu",
                     mso_options=MsoOptions(maxiter=60, pgtol=1e-2), **kw)


def _drive(s, n):
    xs = []
    for _ in range(n):
        tr = s.ask()
        s.tell(tr.trial_id, _sphere(tr.x))
        xs.append(tr.x)
    return np.array(xs)


def t(a):
    return torch.tensor(np.array(a, np.float64))


# ------------------------------------------------------ incremental refit
@pytest.mark.parametrize("with_kinv", [False, True])
def test_incremental_update_matches_from_scratch(with_kinv):
    """Rank-one Cholesky/K⁻¹ append == full refactorization to ≤1e-8,
    growing one observation at a time through a padded buffer."""
    rng = np.random.default_rng(0)
    b, n0 = 24, 7
    p = init_params(D)
    X = rng.uniform(0, 1, (b, D))
    yv = np.sin(4 * X).sum(1)
    x = torch.full((b, D), _FAR, dtype=torch.float64) + \
        torch.arange(b, dtype=torch.float64)[:, None]
    y = torch.zeros(b, dtype=torch.float64)

    def scratch(n):
        v = (torch.arange(b) < n).double()
        Kp = gram(x, p) * (v[:, None] * v[None, :]) + torch.diag(1.0 - v)
        L = torch.linalg.cholesky(Kp)
        ys, _, _ = standardize_masked(y * v, torch.arange(b) < n)
        return (L, tgpr._cho_solve(L, ys),
                tgpr._cho_solve(L, torch.eye(b, dtype=torch.float64)))

    x[:n0], y[:n0] = t(X[:n0]), t(yv[:n0])
    chol, _, kinv = scratch(n0)
    kinv = kinv if with_kinv else None
    for n in range(n0 + 1, b + 1):
        x[n - 1], y[n - 1] = t(X[n - 1]), float(yv[n - 1])
        ys, _, _ = standardize_masked(y, torch.arange(b) < n)
        chol_in = chol.clone()
        chol, alpha, kinv, ok = incremental_update(x, ys, n, p, chol, kinv)
        assert bool(ok), n
        L_ref, a_ref, k_ref = scratch(n)
        torch.testing.assert_close(chol, L_ref, atol=1e-8, rtol=0)
        torch.testing.assert_close(alpha, a_ref, atol=1e-8, rtol=0)
        if with_kinv:
            torch.testing.assert_close(kinv, k_ref, atol=1e-8, rtol=0)
    # functional: the update leaves its inputs alone
    assert not torch.equal(chol_in, chol)


def test_rank_one_updates_match_jax():
    rng = np.random.default_rng(2)
    b, n = 16, 9
    A = rng.standard_normal((n, n))
    Kn = A @ A.T + n * np.eye(n)
    L = np.eye(b)
    L[:n, :n] = np.linalg.cholesky(Kn)
    kinv = np.eye(b)
    kinv[:n, :n] = np.linalg.inv(Kn)
    k_col = np.zeros(b)
    k_col[:n] = rng.standard_normal(n)
    k_diag = float(n + 4.0)
    c_j, s_j = jgpr.cholesky_update(jnp.asarray(L), jnp.asarray(k_col),
                                    jnp.asarray(k_diag), jnp.asarray(n))
    c_t, s_t = tgpr.cholesky_update(t(L), t(k_col), t(k_diag), n)
    k_j = jgpr.kinv_update(jnp.asarray(kinv), jnp.asarray(k_col), s_j,
                           jnp.asarray(n))
    k_t = tgpr.kinv_update(t(kinv), t(k_col), s_t, n)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-12)
    assert abs(float(s_t) - float(s_j)) <= 1e-12 * abs(float(s_j))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=0,
                               atol=1e-12)
    assert k_t.is_contiguous()


def test_incremental_ask_posterior_matches_full_across_buckets():
    """Driving the AskEngine across bucket boundaries, every incremental
    trial's GP state reproduces a from-scratch fit (same θ) to ≤1e-8, and
    a GPState taken before an update is unchanged after it."""
    rng = np.random.default_rng(1)
    cfg = AskConfig(dim=D, n_restarts=4, pad_bucket=8, refit_interval=6,
                    backend="fused")          # exercises the K⁻¹ path
    ask = AskEngine(EvalEngine(fused_logei_acq("fused"), "cpu"), cfg)
    for _ in range(5):
        xi = rng.uniform(0, 1, D)
        ask.observe(xi, _sphere(xi))
    checked, held = 0, None
    for k in range(16):                       # crosses 8- and 16-buckets
        bx, info = ask.suggest(rng.uniform(0, 1, (3, D)), fit_seed=k)
        assert info.fit_evals > 0 or info.kind == "incremental"
        if info.kind == "incremental":
            gp = ask.gp_state()
            n = ask.n_obs
            ref = tgpr.fit_gram(gp.x_train[:n], gp.y_train[:n], gp.params)
            Xq = t(rng.uniform(0, 1, (9, D)))
            for a, r in zip(tgpr.predict(gp, Xq), tgpr.predict(ref, Xq)):
                torch.testing.assert_close(a, r, atol=1e-8, rtol=0)
            torch.testing.assert_close(
                gp.kinv[:n, :n], torch.linalg.inv(tgpr.gram(
                    gp.x_train[:n], gp.params)), atol=1e-8, rtol=1e-8)
            checked += 1
        if held is None and info.kind == "incremental":
            held = ask.gp_state()
            copies = [v.clone() for v in (held.x_train, held.chol,
                                          held.alpha, held.kinv)]
        xn = np.clip(bx, 0, 1)
        ask.observe(xn, _sphere(xn))
    assert checked >= 8                       # incremental trials dominated
    assert ask.n_full_refits >= 3             # boundary + interval refits
    for a, c in zip((held.x_train, held.chol, held.alpha, held.kinv),
                    copies):
        assert torch.equal(a, c)              # no silent alias


# ------------------------------------------------- fused == host pipeline
@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_fused_reproduces_unfused_trajectory_bitwise(backend):
    """With incremental updates disabled (refit_interval=1, no warm
    start), the fused ask reproduces the host dbe_vec pipeline's
    suggestions bit for bit across a bucket boundary."""
    n_trials = 13                             # n = 5..12: buckets 8 and 16
    sa = _sampler(False, refit_interval=1, warm_start=False, backend=backend,
                  pad=8)
    sb = _sampler(True, refit_interval=1, warm_start=False, backend=backend,
                  pad=8)
    np.testing.assert_array_equal(_drive(sa, n_trials), _drive(sb, n_trials))
    assert sb._ask.n_incremental == 0
    assert sb._ask.n_full_refits == n_trials - N_STARTUP


def test_fused_compile_counts_stay_o_buckets_and_fallback():
    """22 trials crossing bucket boundaries: at most one full and one
    incremental program signature per GP size bucket; a vetoed rank-one
    update falls back to the full program."""
    class VetoOnce:
        fired = 0

        def incr_ok(self, ok, tags):
            VetoOnce.fired += 1
            return ok if VetoOnce.fired != 3 else np.zeros_like(ok)

    s = _sampler(True, pad=8)
    best = s.optimize(_sphere, 12)
    s._ask.fault_injector = VetoOnce()
    s.optimize(_sphere, 10)
    ask = s._ask
    assert ask.bucket == 24
    snap = ask.stats_snapshot()
    n_buckets = 3                   # suggests span n=5..21 → pads 8..24
    assert snap["n_full_compiles"] <= n_buckets
    assert snap["n_incr_compiles"] <= n_buckets
    assert snap["n_full_refits"] + snap["n_incremental"] == 22 - N_STARTUP
    assert snap["n_fallbacks"] == 1 and s.engine.stats.n_refit_fallbacks == 1
    assert snap["n_incremental"] > snap["n_full_refits"]
    assert set(snap["retraces"]["causes"]) <= {"first-trace", "shape"}
    eng = s.stats.engine
    assert eng["n_rounds"] == sum(s.stats.acqf_rounds)
    assert eng["kernel_launches"] == dict.fromkeys(K.LAUNCHES, 0)
    assert s.last_ask_info.kind in ("full", "incremental", "fallback")
    assert best.y < 0.25


def test_fused_handles_out_of_order_tell():
    """Two pending asks completed in reverse order must not duplicate or
    drop observations in the fused GP (sync is keyed by trial id)."""
    s = _sampler(True, seed=9)
    _drive(s, N_STARTUP)
    t1, t2 = s.ask(), s.ask()              # two pending suggestions
    s.tell(t2.trial_id, _sphere(t2.x))     # ...completed out of order
    s.tell(t1.trial_id, _sphere(t1.x))
    _drive(s, 3)
    s.ask()                                # final sync into the ask GP
    ask = s._ask
    assert ask.n_obs == 10                 # 5 startup + 2 + 3, no dupes
    done_y = sorted(tr.y for tr in s.trials if tr.state == "complete")
    np.testing.assert_array_equal(sorted(ask._y[:ask.n_obs].tolist()),
                                  done_y)


def test_phase_times_only_while_tracing():
    """The fit and MSO ms of an ask are clocked (and synchronized) only
    while the obs tracer is on, and then also recorded as spans; off, the
    fields stay 0.0 and nothing is recorded."""
    s = _sampler(True, seed=5)
    _drive(s, N_STARTUP)
    tracer = obs.enable()
    try:
        infos = []
        for _ in range(2):                 # a full ask, then an incremental
            _drive(s, 1)
            infos.append(s.last_ask_info)
    finally:
        obs.disable()
    assert [i.kind for i in infos] == ["full", "incremental"]
    assert all(i.fit_ms > 0 and i.mso_ms > 0 for i in infos)
    spans = [(e["name"], e["args"]["program"]) for e in tracer.events()
             if e["name"] in ("ask.phase.fit", "ask.phase.mso")]
    assert spans == [("ask.phase.fit", "full"), ("ask.phase.mso", "full"),
                     ("ask.phase.fit", "incr"), ("ask.phase.mso", "incr")]
    n_events = len(tracer.events())
    _drive(s, 1)
    assert s.last_ask_info.fit_ms == s.last_ask_info.mso_ms == 0.0
    assert len(tracer.events()) == n_events


def test_fused_requires_dbe_vec():
    with pytest.raises(ValueError, match="dbe_vec"):
        GPSampler(BoxSpace.cube(2, 0.0, 1.0), strategy="dbe", fused=True,
                  device="cpu")


# ---------------------------------------------------- against the JAX one
def _jax_restart_draws(seed):
    def draws(n_trials):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), n_trials)
        return np.asarray(jax.random.uniform(key, (B - 1, D), jnp.float64))
    return draws


def _jax_theta_draws(fit_seed, restarts=2):
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(fit_seed), (restarts - 1, D + 2), jnp.float64,
        minval=-1.0, maxval=1.0))


def test_fused_sampler_matches_jax_fused_sampler():
    """The port's fused sampler (cholesky backend) against JAX's fused
    sampler (xla backend), JAX's θ-grid and restart draws injected: full
    refits, warm starts and rank-one trials give the same suggestions to
    1e-6 in unit space (the MAP fit amplifies last-ulp differences)."""
    seed, n = 3, 12                       # asks at n = 5..11: buckets 8, 16
    js = JSampler(JBox.cube(D, -1.0, 1.0), strategy="dbe_vec", seed=seed,
                  n_startup_trials=N_STARTUP, n_restarts=B, pad_multiple=8,
                  posterior_backend="xla",
                  mso_options=JOpts(maxiter=60, pgtol=1e-2))
    ts = _sampler(True, seed=seed, pad=8, theta_draws=_jax_theta_draws,
                  restart_draws=_jax_restart_draws(seed))
    xj, xt = _drive(js, n), _drive(ts, n)
    assert float(np.max(np.abs(xt - xj)) / 2.0) <= 1e-6
    assert ts._ask.n_incremental == js._ask.n_incremental > 0
    assert ts._ask.n_full_refits == js._ask.n_full_refits


def test_one_incremental_step_from_a_jax_state():
    """Both packages take one incremental ask from one state (converted
    with ``convert.ask_engine_from_numpy``): the same factors to 1e-12 and
    the same suggestion to 1e-8 for the same restart draws."""
    rng = np.random.default_rng(4)
    cfg = dict(dim=D, n_restarts=B, pad_bucket=16, refit_interval=8)
    ja = JAskEngine(JEvalEngine(j_logei_acq), JAskConfig(backend="xla",
                                                         **cfg))
    for _ in range(9):
        xi = rng.uniform(0, 1, D)
        ja.observe(xi, _sphere(xi))
    ja.suggest(jax.random.PRNGKey(0), fit_seed=1)
    xi = rng.uniform(0, 1, D)
    ja.observe(xi, _sphere(xi))
    ta = ask_engine_from_numpy(
        EvalEngine(logei_acq, "cpu"), AskConfig(backend="cholesky", **cfg),
        x=np.asarray(ja._x), y=np.asarray(ja._y), n=ja.n_obs,
        n_fit=ja._n_fit, theta=np.asarray(ja._theta),
        chol=np.asarray(ja._chol), alpha=np.asarray(ja._alpha))
    key = jax.random.PRNGKey(7)
    draws = np.asarray(jax.random.uniform(key, (B - 1, D), jnp.float64))
    bj, ij = ja.suggest(key, fit_seed=2)
    bt, it = ta.suggest(draws, fit_seed=2)
    assert ij.kind == it.kind == "incremental" and it.fit_evals == 0
    np.testing.assert_allclose(ta._chol.numpy(), np.asarray(ja._chol),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ta._alpha.numpy(), np.asarray(ja._alpha),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(it.n_iters.numpy(), np.asarray(ij.n_iters))
    np.testing.assert_allclose(bt, np.asarray(bj), rtol=0, atol=1e-8)
