"""The fleet ask plane of the port (``engine/fleet.py``, ``FleetSampler``),
mirroring the reference's ``tests/test_fleet.py`` inside the port: the
study-batched GP cores against per-study calls, slot and company
independence bitwise at a pinned width, the solo pipeline to 1e-10,
program counts independent of the fleet's size; and held against the JAX
package's fleet from the same inputs and injected draws, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bo.sampler import FleetSampler as JFleetSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro.core.acquisition import logei_acq as j_logei_acq  # noqa: E402
from repro.core.lbfgsb import LbfgsbOptions as JLbfgsbOptions  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.engine import EvalEngine as JEvalEngine  # noqa: E402
from repro.engine import FleetConfig as JFleetConfig  # noqa: E402
from repro.engine import FleetEngine as JFleetEngine  # noqa: E402
from repro_torch.bo.sampler import FleetSampler, GPSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.convert import fleet_block_from_numpy  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.lbfgsb import LbfgsbOptions  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.engine.ask import incr_core, refit_core  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.fleet import (FleetConfig, FleetEngine,  # noqa: E402
                                      default_draws)
from repro_torch.engine.posterior import fused_logei_acq  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.gp.fit import (FIT_OPTS, _FAR, theta_bounds,  # noqa: E402
                                theta_init_grid)

_MSO = dict(maxiter=40, pgtol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are thousands of small tensor ops: one intra-op thread a
    test process, so that parallel test workers do not oversubscribe the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
_LB = dict(m=10, maxiter=40, pgtol=1e-2, ftol=0.0, maxls=25)


def _sphere(x):
    return float(np.sum((x - 0.4) ** 2))


def _fleet_kw(**over):
    kw = dict(n_startup_trials=4, n_restarts=4, pad_multiple=8,
              posterior_backend="cholesky", device="cpu",
              mso_options=MsoOptions(**_MSO))
    kw.update(over)
    return kw


def _padded_study(rng, n, b, D):
    """One padded study: n live points in a b-row _FAR-padded buffer."""
    x = np.full((b, D), _FAR) + np.arange(b)[:, None]
    x[:n] = rng.uniform(0, 1, (n, D))
    y = np.zeros((b,))
    y[:n] = np.sin(4 * x[:n]).sum(1)
    return torch.tensor(x), torch.tensor(y)


def _drive(f, rounds, record_study=0):
    xs = []
    for _ in range(rounds):
        if isinstance(f, (FleetSampler, JFleetSampler)):
            trials = f.ask_all()
            xs.append(trials[record_study].x.copy())
            for s, t in enumerate(trials):
                f.tell(s, t.trial_id, _sphere(t.x))
        else:
            t = f.ask()
            xs.append(t.x.copy())
            f.tell(t.trial_id, _sphere(t.x))
    return np.array(xs)


# --------------------------------------------------- study-batched cores
@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_stacked_refit_core_matches_sequential(backend):
    """refit_core on S stacked studies with an (S,) count per slot ==
    per-study calls to <=1e-8 (θ, chol, α, K⁻¹), one lockstep solve."""
    rng = np.random.default_rng(0)
    b, D, R = 16, 3, 2
    ns = [3, 7, 12, 16]
    xs, ys = zip(*[_padded_study(rng, n, b, D) for n in ns])
    x, y = torch.stack(xs), torch.stack(ys)
    thetas = torch.stack([theta_init_grid(D, torch.float64, R, n)
                          for n in ns])
    tlo, tup = theta_bounds(D)
    tlo, tup = tlo.expand(thetas.shape), tup.expand(thetas.shape)

    def core(x_, y_, n_, th, lo, up):
        return refit_core(x_, y_, n_, th, lo, up, dim=D, kernel="matern52",
                          backend=backend, fit_opts=FIT_OPTS)

    out_v = core(x, y, torch.tensor(ns), thetas, tlo, tup)
    for i, n in enumerate(ns):
        out_s = core(x[i], y[i], n, thetas[i], tlo[i], tup[i])
        for leaf_v, leaf_s in zip(out_v[:6], out_s[:6]):
            if leaf_s is None:
                assert leaf_v is None
                continue
            np.testing.assert_allclose(leaf_v[i].numpy(), leaf_s.numpy(),
                                       atol=1e-8)


def test_stacked_incr_core_matches_sequential_across_migration():
    """The rank-one update on stacked studies with per-slot counts: each
    grows one observation at a time, <=1e-8 of per-study calls, also
    after a bucket migration into a larger padded buffer."""
    rng = np.random.default_rng(1)
    D, R, S = 2, 2, 3
    live = [rng.uniform(0, 1, (20, D)) for _ in range(S)]
    yall = [np.sin(3 * X).sum(1) for X in live]

    def seeded(b, ns):
        xs, ys, fits = [], [], []
        for s in range(S):
            x = np.full((b, D), _FAR) + np.arange(b)[:, None]
            x[:ns[s]] = live[s][:ns[s]]
            y = np.zeros((b,))
            y[:ns[s]] = yall[s][:ns[s]]
            x, y = torch.tensor(x), torch.tensor(y)
            th = theta_init_grid(D, torch.float64, R, s)
            lo, up = theta_bounds(D)
            fits.append(refit_core(x, y, ns[s], th, lo.expand(th.shape),
                                   up.expand(th.shape), dim=D,
                                   kernel="matern52", backend="fused",
                                   fit_opts=FIT_OPTS))
            xs.append(x)
            ys.append(y)
        return xs, ys, fits

    def core(x_, y_, n_, th, ch, ki):
        out = incr_core(x_, y_, n_, th, ch, ki, dim=D, kernel="matern52")
        return out[3], out[4], out[5], out[6]

    def check_growth(b, n0, steps):
        ns = [n0, n0 + 1, n0 + 2]
        xs, ys, fits = seeded(b, ns)
        theta = torch.stack([f[2] for f in fits])
        chol = torch.stack([f[3] for f in fits])
        kinv = torch.stack([f[5] for f in fits])
        for _ in range(steps):
            for s in range(S):
                i = ns[s]
                xs[s][i] = torch.tensor(live[s][i])
                ys[s][i] = float(yall[s][i])
                ns[s] = i + 1
            x, y = torch.stack(xs), torch.stack(ys)
            ch_v, al_v, ki_v, ok_v = core(x, y, torch.tensor(ns), theta,
                                          chol, kinv)
            assert bool(ok_v.all())
            for s in range(S):
                ch_s, al_s, ki_s, ok_s = core(x[s], y[s], ns[s], theta[s],
                                              chol[s], kinv[s])
                assert bool(ok_s)
                for a, b_ in ((ch_v[s], ch_s), (al_v[s], al_s),
                              (ki_v[s], ki_s)):
                    np.testing.assert_allclose(a.numpy(), b_.numpy(),
                                               atol=1e-8)
            chol, kinv = ch_v, ki_v
        return ns

    assert check_growth(b=8, n0=3, steps=3) == [6, 7, 8]
    check_growth(b=16, n0=9, steps=4)        # after a bucket migration


# --------------------------------------- slot / batch-composition freedom
def test_fleet_solo_equals_company_bitwise():
    """A study's trajectory is bitwise independent of which other studies
    share the block (refit_interval=1, warm_start=False, crossing a bucket
    boundary)."""
    kw = _fleet_kw(refit_interval=1, warm_start=False)
    space = BoxSpace.cube(2, -1.0, 1.0)
    solo = FleetSampler(space, n_studies=1, seed=5, slots=4, **kw)
    company = FleetSampler(space, n_studies=4, seed=5, slots=4, **kw)
    np.testing.assert_array_equal(_drive(solo, 12), _drive(company, 12))
    assert company.fleet.n_migrations >= 4     # crossed the 8-bucket


def _engine_run(order, cfg, engine_cls, eval_engine, draw, seeds):
    """Drive a fleet engine of either package through three steps (full,
    incremental, ...) with the studies admitted in ``order``."""
    rng = np.random.default_rng(7)
    obs_ = {s: rng.uniform(0, 1, (4, 2)) for s in range(3)}
    fleet = engine_cls(eval_engine, cfg)
    for sid in order:
        fleet.add_study(sid)
        for x in obs_[sid]:
            fleet.observe(sid, x, _sphere(x))
    out = {}
    for trial in range(3):
        for sid in order:
            fleet.request_suggest(sid, draw(sid, trial), seeds(sid))
        fleet.step()
        for sid in order:
            x, info = fleet.pop_result(sid)
            out.setdefault(sid, []).append((np.asarray(x), info.kind))
            xc = np.clip(np.asarray(x), 0, 1)
            fleet.observe(sid, xc, _sphere(xc))
    return out


def test_fleet_slot_permutation_bitwise():
    """Admission order permutes the slots; no study's results move by a
    bit (full and incremental steps)."""
    cfg = FleetConfig(dim=2, n_restarts=4, slots=4, pad_bucket=8,
                      refit_interval=2, warm_start=True, gp_fit_restarts=2,
                      mso=LbfgsbOptions(**_LB))

    def draw(sid, trial):
        return default_draws(100 + sid, trial, 3, 2)

    def run(order):
        return _engine_run(order, cfg, FleetEngine,
                           EvalEngine(logei_acq, "cpu"), draw,
                           lambda sid: sid)

    a, b = run([0, 1, 2]), run([2, 0, 1])
    for sid in range(3):
        kinds = [k for _, k in a[sid]]
        assert kinds == ["full", "incremental", "full"]
        for (xa, ka), (xb, kb) in zip(a[sid], b[sid]):
            assert ka == kb
            np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_fleet_matches_askengine(backend):
    """Fleet suggestions track the solo fused pipeline to 1e-10 over a run
    crossing a bucket boundary, on either posterior backend (the fit's
    Cholesky, solves and sums, and the plain K1's products, run study by
    study, so a study's bits do not depend on the block)."""
    kw = _fleet_kw(refit_interval=1, warm_start=False,
                   posterior_backend=backend)
    space = BoxSpace.cube(2, -1.0, 1.0)
    ref = GPSampler(space, strategy="dbe_vec", fused=True, seed=5, **kw)
    fleet = FleetSampler(space, n_studies=1, seed=5, slots=2, **kw)
    np.testing.assert_allclose(space.to_unit(_drive(fleet, 12)),
                               space.to_unit(_drive(ref, 12)), rtol=0,
                               atol=1e-10)


def test_stacked_map_objective_bitwise_each_study():
    """One MAP-objective evaluation of a 3-study stack (D=5, each study
    with its own count of _FAR rows and its own θ inits): value and
    θ-gradient of each study bitwise the study alone."""
    from repro_torch.gp.fit import _neg_map_objective, standardize_masked
    rng = np.random.default_rng(7)
    S, b, D = 3, 24, 5
    xs, ys = zip(*(_padded_study(rng, n, b, D) for n in (17, 20, 23)))
    x, y = torch.stack(xs), torch.stack(ys)
    valid = torch.arange(b) < torch.tensor([17, 20, 23])[:, None]
    y_std = standardize_masked(y, valid)[0]
    th = torch.stack([theta_init_grid(D, torch.float64, 2, 10 + s)
                      for s in range(S)])

    def objective(t, *args):
        t = t.detach().requires_grad_(True)
        f = _neg_map_objective(t, *args, D, "matern52")
        (g,) = torch.autograd.grad(f.sum(), t)
        return f.detach(), g

    f_all, g_all = objective(th, x, y_std, valid)
    for s in range(S):
        f1, g1 = objective(th[s], x[s], y_std[s], valid[s])
        assert torch.equal(f_all[s], f1) and torch.equal(g_all[s], g1), s


# ----------------------------------------------------- scheduler economy
def test_fleet_compile_counts_independent_of_fleet_size():
    """Three programs per (bucket, slots) at most; serving more studies
    at the same width reuses them."""
    space = BoxSpace.cube(2, -1.0, 1.0)
    counts = {}
    for S in (2, 4):
        fs = FleetSampler(space, n_studies=S, seed=0, slots=2,
                          **_fleet_kw(refit_interval=4))
        fs.optimize(_sphere, 10)
        snap = fs.stats_snapshot()
        n_buckets = len({blk.bucket for blk in fs.fleet._blocks})
        assert snap["n_fleet_compiles"] <= 3 * n_buckets
        counts[S] = (snap["n_fleet_compiles"], n_buckets)
    assert counts[2] == counts[4], counts


def test_fleet_incremental_steady_state_and_quality():
    """Defaults (incremental on, warm starts): rank-one steps dominate,
    no fallbacks, every study still optimizes, and the stats keys."""
    fs = FleetSampler(BoxSpace.cube(2, -1.0, 1.0), n_studies=3, seed=0,
                      slots=4, **_fleet_kw(refit_interval=6))
    best = fs.optimize(_sphere, 16)
    assert all(b.y < 0.25 for b in best), [b.y for b in best]
    snap = fs.stats_snapshot()
    assert snap["n_incremental"] > snap["n_full_refits"]
    assert snap["n_fallbacks"] == 0
    assert snap["n_migrations"] == 3            # every study crossed b=8
    assert snap["n_migrations_intra"] + snap["n_migrations_cross"] \
        == snap["n_migrations"]
    assert snap["n_devices"] == 1 and snap["slots_per_device"] == [3]
    assert snap["queue_depth"] == 0
    # the port's counters: every block program and its batched work
    progs = snap["n_block_programs"]
    assert progs["mso"] == snap["n_steps"] and progs["full"] >= 2
    assert snap["n_fit_evals"] > 0 and snap["n_mso_rounds"] > 0


def test_fleet_stats_placement_keys():
    cfg = FleetConfig(dim=2, n_restarts=4, slots=2, pad_bucket=8,
                      mso=LbfgsbOptions(**dict(_LB, maxiter=20)))
    fleet = FleetEngine(EvalEngine(logei_acq, "cpu"), cfg)
    fleet.add_study("a")
    fleet.add_study("b")
    snap = fleet.stats_snapshot()
    assert snap["slots_per_device"] == [0] and snap["queue_depth"] == 2
    rng = np.random.default_rng(0)
    for x in rng.uniform(0, 1, (2, 2)):
        fleet.observe("a", x, _sphere(x))
        fleet.observe("b", x, _sphere(x))
    fleet.request_suggest("a", fit_seed=0)
    assert fleet.step() == 1
    snap = fleet.stats_snapshot()
    assert snap["queue_depth"] == 0 and snap["slots_per_device"] == [2]
    assert snap["n_fleet_compiles"] == 2           # full + mso


def test_fleet_admission_and_errors():
    cfg = FleetConfig(dim=2, n_restarts=4, slots=2, pad_bucket=8)
    fleet = FleetEngine(EvalEngine(logei_acq, "cpu"), cfg)
    fleet.add_study("a")
    with pytest.raises(ValueError, match="already registered"):
        fleet.add_study("a")
    fleet.observe("a", np.array([0.5, 0.5]), 1.0)
    fleet.request_suggest("a")
    with pytest.raises(ValueError, match=">= 2"):
        fleet.step()
    s = GPSampler(BoxSpace.cube(2, -1.0, 1.0), strategy="dbe_vec",
                  n_startup_trials=1, n_restarts=4, pad_multiple=8,
                  device="cpu")
    t = s.ask()
    s.tell(t.trial_id, 1.0)
    with pytest.raises(ValueError, match="before the first trial"):
        s.attach_fleet(fleet)
    s2 = GPSampler(BoxSpace.cube(2, -1.0, 1.0), strategy="dbe_vec",
                   n_restarts=6, pad_multiple=8, device="cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        s2.attach_fleet(fleet)
    # the fleet's mesh is the study axis alone
    with pytest.raises(ValueError, match="must be 1-D"):
        FleetEngine(EvalEngine(logei_acq, "cpu"), cfg, mesh=Mesh(
            ["cpu"] * 4, ("data", "model"), shape=(2, 2)))


# ---------------------------------------------------- against the JAX one
def _jax_restart_draws(seed, n_trials, B=4, D=2):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), n_trials)
    return np.asarray(jax.random.uniform(key, (B - 1, D), jnp.float64))


def _jax_theta_draws(fit_seed, restarts=2, D=2):
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(fit_seed), (restarts - 1, D + 2), jnp.float64,
        minval=-1.0, maxval=1.0))


@pytest.fixture(scope="module")
def jax_fleet_run():
    """JAX's FleetSampler (xla backend): 3 studies, 2 slots (two blocks),
    refit every 3rd trial with warm starts, 12 rounds across the 8 → 16
    bucket."""
    kw = dict(n_startup_trials=4, n_restarts=4, pad_multiple=8,
              posterior_backend="xla", refit_interval=3,
              mso_options=JOpts(**_MSO))
    fs = JFleetSampler(JBox.cube(2, -1.0, 1.0), n_studies=3, seed=11,
                       slots=2, **kw)
    _drive(fs, 12)
    return fs


def test_fleet_sampler_matches_jax_fleet_sampler(jax_fleet_run):
    """The port's FleetSampler (cholesky backend) against JAX's (xla),
    JAX's θ-grid and restart draws injected: every study's suggestions
    agree to 1e-6 in unit space (the MAP fit amplifies last-ulp
    differences), with the same refit kinds."""
    js = jax_fleet_run
    ts = FleetSampler(BoxSpace.cube(2, -1.0, 1.0), n_studies=3, seed=11,
                      slots=2, **_fleet_kw(refit_interval=3),
                      theta_draws=_jax_theta_draws,
                      restart_draws=_jax_restart_draws)
    _drive(ts, 12)
    for i in range(3):
        xj = np.array([t.x for t in js.samplers[i].trials])
        xt = np.array([t.x for t in ts.samplers[i].trials])
        assert float(np.max(np.abs(xt - xj)) / 2.0) <= 1e-6, i
    sj, st = js.stats_snapshot(), ts.stats_snapshot()
    for key in ("n_full_refits", "n_incremental", "n_migrations",
                "n_admissions", "n_blocks"):
        assert st[key] == sj[key], key
    assert st["n_incremental"] > 0


@pytest.mark.parametrize("backend", ["cholesky", "fused"])
def test_one_fleet_step_from_a_jax_block_state(backend):
    """Both packages take one fleet step from one block state (carried by
    ``convert.fleet_block_from_numpy``), one slot incremental, one full
    and one idle: the same factors to 1e-12 and the same suggestions to
    1e-8 for the same draws."""
    rng = np.random.default_rng(4)
    D, B = 2, 4
    cfg = dict(dim=D, n_restarts=B, slots=3, pad_bucket=16,
               refit_interval=8)
    jb = "xla" if backend == "cholesky" else "pallas_interpret"
    jf = JFleetEngine(JEvalEngine(j_logei_acq), JFleetConfig(
        backend=jb, mso=JLbfgsbOptions(**_LB), **cfg))
    for sid in (0, 1):
        jf.add_study(sid)
        for _ in range(6 + 2 * sid):
            xi = rng.uniform(0, 1, D)
            jf.observe(sid, xi, _sphere(xi))
        jf.request_suggest(sid, jax.random.PRNGKey(sid), fit_seed=sid)
    jf.step()
    for sid in (0, 1):
        jf.pop_result(sid)
    xi = rng.uniform(0, 1, D)
    jf.observe(0, xi, _sphere(xi))           # study 0: one more → rank one
    blk = jf._blocks[0]
    recs = [None] * 3
    for st in blk.studies:
        if st is not None:
            recs[st.slot] = dict(sid=st.sid, n=st.n, n_fit=st.n_fit,
                                 since_refit=st.since_refit,
                                 has_factor=st.has_factor,
                                 has_theta=st.has_theta, trial=st.trial)
    recs[jf._studies[1].slot]["has_factor"] = False   # study 1: full refit
    jf._studies[1].has_factor = False
    acq = logei_acq if backend == "cholesky" else fused_logei_acq("fused")
    tf = FleetEngine(EvalEngine(acq, "cpu"), FleetConfig(
        backend=backend, mso=LbfgsbOptions(**_LB), **cfg))
    fleet_block_from_numpy(
        tf, x=np.asarray(blk.x), y=np.asarray(blk.y),
        theta=np.asarray(blk.theta), chol=np.asarray(blk.chol),
        alpha=np.asarray(blk.alpha),
        kinv=None if blk.kinv is None else np.asarray(blk.kinv),
        studies=recs)
    keys = {sid: jax.random.PRNGKey(50 + sid) for sid in (0, 1)}
    for sid in (0, 1):
        jf.request_suggest(sid, keys[sid], fit_seed=7)
        tf.request_suggest(sid, np.asarray(jax.random.uniform(
            keys[sid], (B - 1, D), jnp.float64)), fit_seed=7,
            theta_draws=_jax_theta_draws(7))
    jf.step()
    tf.step()
    jb_, tb = jf._blocks[0], tf._blocks[0]
    for a, b in ((tb.chol, jb_.chol), (tb.alpha, jb_.alpha),
                 (tb.theta, jb_.theta)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12 if a is not tb.theta else 1e-8)
    for sid, kind in ((0, "incremental"), (1, "full")):
        xj, ij = jf.pop_result(sid)
        xt, it = tf.pop_result(sid)
        assert ij.kind == it.kind == kind
        np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=1e-8)
