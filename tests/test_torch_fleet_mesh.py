"""The fleet across several devices (``launch/mesh.py``,
``distributed/sharding.py``, ``FleetEngine(mesh=)``) on the CPU.

Meshes here are virtual entries of the CPU (``make_fleet_mesh(n,
device="cpu")``), the counterpart of the reference's forced host
devices: every shard runs its own fixed-width programs, one after
another, exactly as a mesh of cards runs them.  Twins of the reference's
``tests/test_fleet_mesh.py`` (placement independence bitwise, the
cross-device migration against the solo ask), of its 1-device mesh test
(``tests/test_fleet.py``), recovery onto a mesh, ``pspec`` against the
reference's, and the sharded fleet against JAX's fleet.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faults import FaultInjector, VirtualClock  # noqa: E402
from repro.distributed.sharding import fleet_pspec as j_fleet_pspec  # noqa: E402,E501
from repro.distributed.sharding import pspec as j_pspec  # noqa: E402
from repro_torch.bo.journal import InjectedCrash  # noqa: E402
from repro_torch.bo.sampler import FleetSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.lbfgsb import LbfgsbOptions  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.distributed.sharding import (AXIS_CANDIDATES,  # noqa: E402
                                              Sharded, fleet_pspec,
                                              fleet_shard, pspec)
from repro_torch.engine.ask import AskConfig, AskEngine  # noqa: E402
from repro_torch.engine.cache import CountingJit  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.fleet import (FleetConfig, FleetEngine,  # noqa: E402
                                      default_draws)
from repro_torch.launch.mesh import Mesh, make_fleet_mesh  # noqa: E402
from repro_torch.serve.bo_service import BOService  # noqa: E402

import test_torch_faults as TFA  # noqa: E402
import test_torch_fleet as TFL  # noqa: E402
import test_torch_service as TSV  # noqa: E402

# the other modules' runs these tests are held against (module fixtures)
_one_thread = TFL._one_thread
jax_fleet_run = TFL.jax_fleet_run
uninterrupted = TFA.uninterrupted
ref_service_run = TSV.ref_service_run

_sphere = TFL._sphere


def _cpu_mesh(n):
    return make_fleet_mesh(n, device="cpu")


# ------------------------------------------------------------ the mesh
def test_make_fleet_mesh_and_mesh_checks():
    m = _cpu_mesh(4)
    assert m.size == 4 and m.axis_names == ("study",) and m.shape == (4,)
    assert _cpu_mesh(None).devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="n_devices >= 1"):
        _cpu_mesh(0)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_fleet_mesh(1, device="meta")
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(["cpu"] * 3, ("data", "model"), shape=(2, 2))
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


def test_sharded_leaf_indexing_and_shard_map():
    """A leaf splits into row shards; a slot index reaches its shard's
    row; shard_map runs once per shard and joins the results; a counted
    program over a mesh counts a call, not a shard."""
    mesh = _cpu_mesh(3)
    x = torch.arange(6 * 4, dtype=torch.float64).reshape(6, 4)
    sx = fleet_shard(mesh, x, 2)
    assert sx.shape == (6, 4)
    assert [s.shape for s in sx.shards] == [(2, 4)] * 3
    assert torch.equal(sx[3], x[3]) and torch.equal(sx[5, 1:], x[5, 1:])
    sx[4, 2] = -1.0
    sx[1] = np.zeros(4)
    x[4, 2], x[1] = -1.0, 0.0
    assert torch.equal(sx.cpu(), x)
    with pytest.raises(IndexError):
        sx[6]
    with pytest.raises(ValueError, match="does not split"):
        fleet_shard(mesh, x[:5], 2)
    calls = []

    def fn(a, scale):
        calls.append(a.shape[0])
        return a * scale, {"rows": a.shape[0]}, None

    for n in (1, 3):
        m = _cpu_mesh(n)
        prog = CountingJit(fn, mesh=m)
        for _ in range(2):
            out, stats, none = prog(fleet_shard(m, x, 6 // n), 2.0)
        assert isinstance(out, Sharded) and torch.equal(out.cpu(), 2 * x)
        assert stats["rows"] == [6 // n] * n and none is None
        assert prog.n_compiles == 1 and prog.n_calls == 2
    assert calls == [6, 6] + [2] * 6


def _cases():
    names = ("pod", "data", "model")
    sizes = {"pod": 2, "data": 16, "model": 16}
    yield (256, 4096), ("batch", None), names, sizes
    yield ((128, 32768, 8, 128), ("batch_full", "kv_seq", "kv_heads",
                                  "head"), names, sizes)
    yield (64, 64), ("vocab", "ff"), names, sizes
    yield (8, 8), ("batch", "vocab"), ("data", "model"), {"data": 1,
                                                         "model": 1}
    rng = np.random.default_rng(0)
    logical = list(AXIS_CANDIDATES)
    mesh_axes = ("pod", "data", "model", "seq")
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(2 ** rng.integers(0, 10)) * int(rng.choice(
            [1, 3])) for _ in range(nd))
        axes = tuple(logical[int(rng.integers(len(logical)))]
                     for _ in range(nd))
        k = int(rng.integers(1, 5))
        names = tuple(rng.choice(mesh_axes, size=k, replace=False))
        sizes = {a: int(rng.choice([1, 2, 4, 8, 16])) for a in names}
        yield shape, axes, names, sizes


def test_pspec_matches_the_reference():
    """The reference's cases (``tests/test_distributed.py``) and a seeded
    sweep of shapes, logical axes and meshes: the port's spec is the
    reference's PartitionSpec entry for entry."""
    n = 0
    for shape, axes, names, sizes in _cases():
        assert pspec(shape, axes, names, sizes) == \
            tuple(j_pspec(shape, axes, names, sizes)), (shape, axes, sizes)
        n += 1
    assert n == 304
    for nd in (1, 2, 3):
        assert fleet_pspec(nd) == tuple(j_fleet_pspec(nd))
    with pytest.raises(ValueError):
        fleet_pspec(0)


# ------------------------------------------------- placement independence
def _fleet_kw(**over):
    kw = dict(n_startup_trials=4, n_restarts=4, pad_multiple=8,
              posterior_backend="cholesky", refit_interval=4,
              mso_options=MsoOptions(maxiter=40, pgtol=1e-2))
    kw.update(over)
    return kw


def _drive_all(fs, rounds):
    xs = []
    for _ in range(rounds):
        trials = fs.ask_all()
        xs.append(np.stack([t.x for t in trials]))
        for s, t in enumerate(trials):
            fs.tell(s, t.trial_id, _sphere(t.x))
    return np.stack(xs), fs.stats_snapshot()


def test_fleet_placement_independence_bitwise():
    """8 studies, 2 slots a device: on one device and on eight, every
    suggestion bitwise and the same program count; the eight-device fleet
    balances one study a device and moves every study across the 8 → 16
    bucket."""
    space = BoxSpace.cube(2, -1.0, 1.0)

    def drive(mesh):
        fs = FleetSampler(space, n_studies=8, seed=5, slots=2, mesh=mesh,
                          device="cpu", **_fleet_kw())
        return _drive_all(fs, 10)

    x1, s1 = drive(_cpu_mesh(1))
    x8, s8 = drive(_cpu_mesh(8))
    np.testing.assert_array_equal(x1, x8)
    assert s1["n_fleet_compiles"] == s8["n_fleet_compiles"]
    assert s8["n_devices"] == 8 and s1["n_devices"] == 1
    assert s8["slots_per_device"] == [1] * 8, s8["slots_per_device"]
    assert s8["n_migrations"] == 8             # every study crossed b=8
    assert s8["n_migrations_intra"] + s8["n_migrations_cross"] == 8
    assert s1["n_migrations_intra"] == 8 and s1["n_migrations_cross"] == 0
    # every shard ran every program: per-shard counts scale with the mesh
    assert s8["n_block_programs"]["mso"] % 8 == 0


def test_fleet_mesh1_matches_unsharded_bitwise():
    """A 1-device fleet mesh is plumbing: trajectories and program counts
    match the unsharded fleet bit for bit (the reference's in-process
    twin)."""
    space = BoxSpace.cube(2, -1.0, 1.0)
    kw = _fleet_kw(device="cpu")
    plain = FleetSampler(space, n_studies=3, seed=5, slots=3, **kw)
    meshed = FleetSampler(space, n_studies=3, seed=5, slots=3,
                          mesh=_cpu_mesh(1), **kw)
    xp, sp = _drive_all(plain, 10)
    xm, sm = _drive_all(meshed, 10)
    np.testing.assert_array_equal(xp, xm)
    assert sp["n_fleet_compiles"] == sm["n_fleet_compiles"]
    assert sm["n_devices"] == 1 and meshed.fleet.mesh is not None


def test_fleet_cross_device_migration_matches_askengine():
    """Bucket growth that re-admits a study on the other device is exact:
    <=1e-10 against the solo AskEngine, the full program on its first
    suggest after the move, one cross-device migration."""
    kw = dict(dim=2, n_restarts=4, pad_bucket=8, refit_interval=6,
              warm_start=True, gp_fit_restarts=2,
              mso=LbfgsbOptions(m=10, maxiter=40, pgtol=1e-2, ftol=0.0,
                                maxls=25))
    # 2 slots in all, 1 a device: admission order pins the placement
    fleet = FleetEngine(EvalEngine(logei_acq, "cpu"),
                        FleetConfig(slots=1, **kw), mesh=_cpu_mesh(2))
    ref = AskEngine(EvalEngine(logei_acq, "cpu"), AskConfig(**kw))
    rng = np.random.default_rng(0)
    obs = {sid: rng.uniform(0, 1, (n, 2))
           for sid, n in (("D", 9), ("E", 4), ("A", 4))}
    for sid in ("D", "E", "A"):
        fleet.add_study(sid)
        for x in obs[sid]:
            fleet.observe(sid, x, _sphere(x))
    for x in obs["A"]:
        ref.observe(x, _sphere(x))
    # balanced admission: D (bucket 16) → device 0, E (bucket 8) → device
    # 1, A (bucket 8) → the free device-0 slot.  E then idles; A grows
    # 4 → 9 and re-admits into the free bucket-16 slot on device 1
    seed_of = {"D": 0, "A": 2}
    kinds = []
    for t in range(7):
        for sid in ("D", "A"):
            fleet.request_suggest(
                sid, default_draws(100 + seed_of[sid], t, 3, 2), fit_seed=t)
        fleet.step()
        for sid in ("D", "A"):
            x, info = fleet.pop_result(sid)
            if sid == "A":
                xr, info_r = ref.suggest(default_draws(102, t, 3, 2),
                                         fit_seed=t)
                err = float(np.max(np.abs(x - xr)))
                assert err <= 1e-10, (t, err)
                assert info.kind == info_r.kind, (t, info.kind, info_r.kind)
                kinds.append(info.kind)
                xo = np.clip(x, 0, 1)
                ref.observe(xo, _sphere(xo))
            xo = np.clip(x, 0, 1)
            fleet.observe(sid, xo, _sphere(xo))
    snap = fleet.stats_snapshot()
    assert kinds[5] == "full", kinds
    assert snap["n_migrations"] == 1, snap
    assert snap["n_migrations_cross"] == 1, snap
    assert snap["n_migrations_intra"] == 0, snap
    assert snap["slots_per_device"] == [1, 2], snap


# ------------------------------------------------------ recovery on a mesh
def test_fleet_sampler_recovers_onto_a_mesh_bitwise(tmp_path, uninterrupted):
    """A fleet on a 2-device mesh killed past a checkpoint recovers onto a
    2-device mesh; each study's suggestions equal the uninterrupted
    unsharded twin's bit for bit (refit_interval=1)."""
    d = str(tmp_path)
    sp = BoxSpace.cube(3, 0.0, 1.0)
    rounds = 10                          # round 10 asks in bucket 16
    vic = FleetSampler([sp] * 2, seed=0, journal_dir=d, mesh=_cpu_mesh(2),
                       fault_injector=FaultInjector(kill_at_seq=26),
                       **TFA._fleet_kw())
    with pytest.raises(InjectedCrash):
        for r in range(rounds):
            if r == 3:
                vic.checkpoint()
            TFA._drive(vic, 1)
    with pytest.warns(UserWarning, match="dropping"):
        fs, rep = FleetSampler.recover(d, device="cpu", mesh=_cpu_mesh(2))
    assert rep.snapshot_step is not None and rep.n_replayed > 0
    for i, tid in rep.pending:
        fs.tell(i, tid, _sphere(fs.samplers[i].trials[tid].x))
    done = min(len(s.trials) for s in fs.samplers)
    TFA._drive(fs, rounds - done + 1)
    for i in range(2):
        a, b = uninterrupted.samplers[i].trials, fs.samplers[i].trials
        assert min(len(a), len(b)) >= rounds
        for k in range(rounds):
            np.testing.assert_array_equal(a[k].x, b[k].x,
                                          err_msg=f"study {i} trial {k}")
    snap = fs.stats_snapshot()
    assert snap["n_devices"] == 2 and snap["slots_per_device"] == [1, 1]


def test_service_recovers_onto_a_mesh_bitwise(tmp_path, ref_service_run):
    """The BO service on a 2-device mesh, killed mid-script, recovers onto
    a 2-device mesh; every study's trajectory equals the uninterrupted
    unsharded service's bit for bit (refit_interval=1)."""
    d = str(tmp_path)
    rounds, ref_x = ref_service_run
    svc, _ = TSV._mk_service(2, TSV._SCRIPT_TENANTS, journal_dir=d,
                             fi=FaultInjector(kill_at_seq=40),
                             fleet_over=dict(mesh=_cpu_mesh(2)))
    with pytest.raises(InjectedCrash):
        TSV._run_script(svc, rounds)
    with pytest.warns(UserWarning, match="dropping"):
        svc2, rep = BOService.recover(d, device="cpu", mesh=_cpu_mesh(2),
                                      clock=VirtualClock())
    assert svc2.fs.fleet.stats_snapshot()["n_devices"] == 2
    for i, tid in rep.pending:
        svc2.submit_tell(svc2._study_owner[i], i, tid,
                         _sphere(svc2.fs.samplers[i].trials[tid].x))
    queued = svc2.recovered["queued"]
    if queued:
        TSV._serve(svc2, queued)
        for r in queued:
            svc2.submit_tell(r.tenant, r.study, r.result.trial_id,
                             _sphere(r.result.x))
    while True:
        todo = [i for i in range(2)
                if len(svc2.fs.samplers[i].trials) < rounds]
        if not todo:
            break
        reqs = [svc2.submit_ask(svc2._study_owner[i], i) for i in todo]
        TSV._serve(svc2, reqs)
        for r in reqs:
            svc2.submit_tell(r.tenant, r.study, r.result.trial_id,
                             _sphere(r.result.x))
    for i in range(2):
        got = svc2.fs.samplers[i].trials
        for k in range(rounds):
            np.testing.assert_array_equal(ref_x[i][k], got[k].x,
                                          err_msg=f"study {i} trial {k}")


# ------------------------------------------------------- against the JAX one
def test_sharded_fleet_sampler_matches_jax_fleet_sampler(jax_fleet_run):
    """The port's FleetSampler on a 2-device mesh against JAX's unsharded
    one (JAX's θ-grid and restart draws injected): every study's
    suggestions to 1e-6 in unit space, as the unsharded port's
    (``test_torch_fleet.py``), with the same refit kinds and economy."""
    js = jax_fleet_run
    ts = FleetSampler(BoxSpace.cube(2, -1.0, 1.0), n_studies=3, seed=11,
                      slots=2, mesh=_cpu_mesh(2),
                      **TFL._fleet_kw(refit_interval=3),
                      theta_draws=TFL._jax_theta_draws,
                      restart_draws=TFL._jax_restart_draws)
    TFL._drive(ts, 12)
    for i in range(3):
        xj = np.array([t.x for t in js.samplers[i].trials])
        xt = np.array([t.x for t in ts.samplers[i].trials])
        assert float(np.max(np.abs(xt - xj)) / 2.0) <= 1e-6, i
    sj, st = js.stats_snapshot(), ts.stats_snapshot()
    for key in ("n_full_refits", "n_incremental", "n_migrations",
                "n_admissions"):
        assert st[key] == sj[key], key
    assert st["n_incremental"] > 0 and st["n_devices"] == 2
