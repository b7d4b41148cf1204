"""The slice as a whole: the port's GPSampler (D-BE host pipeline) against
the JAX package's on one BO run, and its device and option rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bo.objectives import make_objective  # noqa: E402
from repro.bo.sampler import GPSampler as JSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro_torch.bo.sampler import FleetSampler, GPSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.engine.plan import EvalPlan  # noqa: E402

D, N_STARTUP, N_BO, FIT_RESTARTS = 3, 8, 3, 2


def reference_theta_draws(seed):
    """The JAX sampler's θ-grid jitter for the fit with this seed
    (``repro.gp.fit.theta_init_grid``)."""
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (FIT_RESTARTS - 1, D + 2), jnp.float64,
        minval=-1.0, maxval=1.0))


def run(sampler, obj, n):
    xs = []
    for _ in range(n):
        t = sampler.ask()
        sampler.tell(t.trial_id, obj(t.x))
        xs.append(t.x)
    return np.array(xs)


@pytest.fixture(scope="module")
def runs():
    obj = make_objective("rosenbrock", D)
    n = N_STARTUP + N_BO
    js = JSampler(JBox.cube(D, -5.0, 5.0), strategy="dbe",
                  n_startup_trials=N_STARTUP, seed=0,
                  gp_fit_restarts=FIT_RESTARTS, posterior_backend="xla")
    out = {"jax": run(js, obj, n)}
    for backend in ("cholesky", "fused"):
        ts = GPSampler(BoxSpace.cube(D, -5.0, 5.0), strategy="dbe",
                       n_startup_trials=N_STARTUP, seed=0,
                       gp_fit_restarts=FIT_RESTARTS,
                       posterior_backend=backend, device="cpu",
                       theta_draws=reference_theta_draws)
        out[backend] = run(ts, obj, n)
        out[backend + "_sampler"] = ts
    return out


def test_startup_points_bitwise_equal(runs):
    # both draw startup points from np.random.default_rng(seed)
    np.testing.assert_array_equal(runs["cholesky"][:N_STARTUP],
                                  runs["jax"][:N_STARTUP])


def test_bo_suggestions_match_jax(runs):
    # same fit inits and restart draws; the MAP fit and scipy's L-BFGS-B
    # amplify last-ulp differences, so compare in unit space to 1e-6
    du = np.abs(runs["cholesky"] - runs["jax"]) / 10.0
    assert float(du.max()) <= 1e-6, du.max()


def test_fused_matches_cholesky_within_port(runs):
    du = np.abs(runs["fused"] - runs["cholesky"]) / 10.0
    assert float(du.max()) <= 1e-6, du.max()
    s = runs["fused_sampler"]
    assert s.stats.n_gp_fits == N_BO and len(s.stats.acqf_rounds) == N_BO
    gp, _ = s.last_acq_state
    assert gp.kinv is not None and gp.kinv.is_contiguous()
    # the no-gradient scoring entry agrees with the evaluator's values
    X = np.random.default_rng(5).uniform(0, 1, (4, D))
    f, _ = s.engine.evaluator(s.last_acq_state, EvalPlan.for_batch(4, D))(X)
    np.testing.assert_allclose(s.engine.values(s.last_acq_state, X), -f,
                               rtol=1e-14, atol=0)
    assert s.best().y == min(t.y for t in s.trials)


def test_device_rules():
    space = BoxSpace.cube(2, 0.0, 1.0)
    if not torch.cuda.is_available():
        # entry points run on the card unless the caller asks for the CPU
        for strategy in ("dbe", "dbe_vec"):
            with pytest.raises(RuntimeError, match="CUDA"):
                GPSampler(space, strategy=strategy)
    s = GPSampler(space, device="cpu")
    assert s.device.type == "cpu" and s.posterior_backend == "cholesky"
    # dbe_vec takes the fused ask by default, the host pipeline on request
    assert GPSampler(space, strategy="dbe_vec", device="cpu").fused
    assert not GPSampler(space, strategy="dbe_vec", device="cpu",
                         fused=False).fused


def test_unported_options_raise_naming_the_roadmap():
    space = BoxSpace.cube(2, 0.0, 1.0)
    with pytest.raises(ValueError, match="dbe_vec"):
        GPSampler(space, device="cpu", fused=True)
    s = GPSampler(space, device="cpu")
    for call in (lambda: s.attach_fleet(None), lambda: s.save("x"),
                 lambda: GPSampler.load("x"), lambda: FleetSampler()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError, match="non-finite"):
        t = s.ask()
        s.tell(t.trial_id, float("nan"))
