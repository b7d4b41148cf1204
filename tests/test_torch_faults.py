"""The port's durability and robustness layer, mirroring the reference's
``tests/test_faults.py``: the write-ahead journal, checkpoints, non-finite
tells, admission backpressure, degrading to solo, quarantine and park
through ``tests/faults.py``'s injector, the Schur-complement fallback, and
``recover`` bitwise at several kill offsets; and the journal, checkpoint
and ``GPSampler.save`` files of the JAX package read by the port (and
back), on the CPU."""
import json
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faults import FaultInjector  # noqa: E402
from repro.bo.journal import StudyJournal as JStudyJournal  # noqa: E402
from repro.bo.sampler import FleetSampler as JFleetSampler  # noqa: E402
from repro.bo.sampler import GPSampler as JSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro_torch.bo.journal import InjectedCrash, StudyJournal  # noqa: E402
from repro_torch.bo.sampler import FleetSampler, GPSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.lbfgsb import LbfgsbOptions  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.engine.ask import AskConfig, AskEngine  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.fleet import (FleetConfig, FleetEngine,  # noqa: E402
                                      FleetFullError, FleetStudyError,
                                      default_draws)
from repro_torch.gp.fit import incremental_update, standardize_masked  # noqa: E402,E501
from repro_torch.gp.kernels import KernelParams, gram  # noqa: E402

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


def _sphere(x):
    return float(np.sum((x - 0.4) ** 2))


def _fleet_kw(**over):
    kw = dict(n_startup_trials=4, n_restarts=4, pad_multiple=8, slots=4,
              posterior_backend="cholesky", refit_interval=1,
              warm_start=False, mso_options=MsoOptions(**_MSO),
              device="cpu")
    kw.update(over)
    return kw


def _drive(fs, rounds):
    for _ in range(rounds):
        for i, t in enumerate(fs.ask_all()):
            fs.tell(i, t.trial_id, _sphere(t.x))


def _journal_records(d):
    path = os.path.join(d, "journal.log")
    return StudyJournal._scan_and_truncate(path, truncate=False)[0]


def _engine(**cfg):
    return FleetEngine(EvalEngine(logei_acq, "cpu"),
                       FleetConfig(dim=2, n_restarts=4, **cfg))


# ============================================================ journal
def test_journal_roundtrip_and_reopen(tmp_path):
    d = str(tmp_path)
    j = StudyJournal(d)
    for i in range(5):
        assert j.append({"op": "ask", "i": i}) == i
    j.close()
    with pytest.raises(ValueError, match="closed"):
        j.append({"op": "ask"})
    j2 = StudyJournal(d)                 # reopen continues the sequence
    assert j2.seq == 5 and j2.truncated_bytes == 0
    assert j2.append({"op": "tell"}) == 5
    recs = j2.replay()
    assert [r["seq"] for r in recs] == list(range(6))
    assert recs[3] == {"seq": 3, "op": "ask", "i": 3}
    j2.close()


def test_journal_truncates_torn_tail(tmp_path):
    """A partial last line (a crash mid-append) is dropped at open and the
    next append reuses its sequence number."""
    d = str(tmp_path)
    j = StudyJournal(d)
    for i in range(4):
        j.append({"op": "ask", "i": i})
    j.close()
    with open(j.path, "ab") as f:
        f.write(b"deadbeef {\"seq\": 4, \"op\"")
    with pytest.warns(UserWarning, match="dropping"):
        j2 = StudyJournal(d)
    assert j2.seq == 4 and j2.truncated_bytes > 0
    assert j2.append({"op": "ask", "i": 4}) == 4
    assert len(j2.replay()) == 5
    j2.close()


def test_journal_crc_corruption_truncates_from_there(tmp_path):
    d = str(tmp_path)
    j = StudyJournal(d)
    for i in range(6):
        j.append({"op": "ask", "i": i})
    j.close()
    with open(j.path, "rb") as f:
        lines = f.readlines()
    lines[3] = lines[3].replace(b'"i":3', b'"i":9')   # payload vs crc
    with open(j.path, "wb") as f:
        f.writelines(lines)
    with pytest.warns(UserWarning, match="dropping"):
        j2 = StudyJournal(d)
    assert j2.seq == 3
    assert [r["i"] for r in j2.replay()] == [0, 1, 2]
    j2.close()


def test_injected_crash_leaves_torn_record(tmp_path):
    d = str(tmp_path)
    j = StudyJournal(d, fault_injector=FaultInjector(kill_at_seq=2))
    j.append({"op": "a"})
    j.append({"op": "b"})
    with pytest.raises(InjectedCrash):
        j.append({"op": "c"})
    with pytest.warns(UserWarning, match="dropping"):
        j2 = StudyJournal(d)
    assert j2.seq == 2 and j2.truncated_bytes > 0
    j2.close()


# ========================================================= checkpoints
def test_ckpt_dtype_mismatch_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore(1, {"x": torch.ones(3, dtype=torch.float32)})
    out = mgr.restore(1, {"x": torch.zeros(3, dtype=torch.float64)})
    assert torch.equal(out["x"], torch.ones(3, dtype=torch.float64))


def test_ckpt_latest_step_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_flat(1, {"x": np.ones(3)})
    mgr.save_flat(2, {"x": np.ones(3)})
    with open(mgr._path(2), "wb") as f:
        f.write(b"not a zip archive")
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr.latest_step() == 1


def test_ckpt_tmp_files_cleaned_on_init(tmp_path):
    d = str(tmp_path)
    leftover = os.path.join(d, ".tmp_7_999")
    with open(leftover, "w") as f:
        f.write("dead writer")
    CheckpointManager(d)
    assert not os.path.exists(leftover)


def test_ckpt_flat_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    flat = {"a": np.arange(6, dtype=np.float64).reshape(2, 3),
            "b": np.asarray(7, np.int64),
            "c": np.asarray(json.dumps(["x", None]))}
    mgr.save_flat(3, flat)
    out = mgr.load_flat(3)
    np.testing.assert_array_equal(out["a"], flat["a"])
    assert int(out["b"]) == 7
    assert json.loads(str(out["c"])) == ["x", None]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_format_shared_with_the_jax_package(tmp_path, writer):
    """A tree checkpoint of one package restores in the other: the same
    flat zip under the same keys."""
    tree = {"w": np.arange(4.0), "blk": {"b": np.ones((2, 2)),
                                          "l": [np.asarray(3, np.int64)]}}
    if writer == "jax":
        JCkpt(str(tmp_path), async_save=False).save(
            5, jax.tree.map(jnp.asarray, tree), block=True)
        out = CheckpointManager(str(tmp_path)).restore(5, tree)
    else:
        CheckpointManager(str(tmp_path)).save(5, tree)
        out = JCkpt(str(tmp_path)).restore(5, tree)
    np.testing.assert_array_equal(np.asarray(out["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(out["blk"]["b"]),
                                  tree["blk"]["b"])
    assert int(out["blk"]["l"][0]) == 3


# ================================================== tell() guardrails
def test_tell_nonfinite_raises_and_failed_never_enters_gp():
    s = GPSampler(BoxSpace.cube(2, 0.0, 1.0), strategy="dbe_vec",
                  n_startup_trials=4, seed=0, device="cpu")
    t0, t1 = s.ask(), s.ask()
    with pytest.raises(ValueError, match=rf"trial {t0.trial_id}.*failed"):
        s.tell(t0.trial_id, float("nan"))
    assert s.trials[t0.trial_id].state == "pending"
    s.tell(t0.trial_id, 1.0)
    s.tell(t1.trial_id, float("inf"), failed=True, error="diverged")
    X, y = s._observations()
    assert X.shape[0] == 1 and np.all(np.isfinite(y))
    assert s.trials[t1.trial_id].state == "failed"


def test_fleet_tell_nonfinite_refused_before_journal(tmp_path):
    d = str(tmp_path)
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)], journal_dir=d,
                      **_fleet_kw())
    t = fs.ask_all()[0]                  # startup: random, no programs
    with pytest.raises(ValueError, match="failed=True"):
        fs.tell(0, t.trial_id, float("-inf"))
    assert _journal_records(d)[-1]["op"] == "ask"
    fs.tell(0, t.trial_id, 0.0, failed=True, error="boom")
    last = _journal_records(d)[-1]
    assert last["op"] == "tell" and last["failed"] and last["y"] is None
    with pytest.raises(ValueError, match="failed=True"):
        fs.fleet.observe(0, np.full(2, 0.5), float("nan"), tag=9)


# ================================================ backpressure / shed
def test_admission_backpressure_rejects_with_reason():
    eng = _engine(max_studies=1)
    eng.add_study("a")
    with pytest.raises(FleetFullError, match="max_studies=1"):
        eng.add_study("b")
    eng2 = _engine(max_queue=1)
    eng2.add_study("a")
    with pytest.raises(FleetFullError, match="queue full"):
        eng2.add_study("b")
    assert eng.stats_snapshot()["n_rejected"] == 1


def test_fleet_sampler_degrades_to_solo_on_rejection():
    sp = BoxSpace.cube(2, 0.0, 1.0)
    with pytest.raises(FleetFullError):
        FleetSampler([sp] * 3, max_studies=2, **_fleet_kw())
    fs = FleetSampler([sp] * 3, max_studies=2, degrade_to_solo=True,
                      **_fleet_kw())
    degraded = [s for s in fs.samplers if s.degraded is not None]
    assert len(fs) == 3 and len(degraded) == 1
    assert degraded[0]._fleet is None
    snap = fs.stats_snapshot()
    assert snap["n_rejected"] == 1 and snap["n_degraded"] == 1
    _drive(fs, 6)                        # the solo study keeps asking
    assert all(len(s.trials) == 6 for s in fs.samplers)


def test_admission_deadline_load_shed():
    eng = _engine(slots=2, pad_bucket=8, max_blocks=1)
    for sid in ("a", "b"):               # fill the only block's 2 slots
        eng.add_study(sid)
        eng.observe(sid, np.full(2, 0.5), 1.0)
    eng.step()
    eng.add_study("c", deadline=time.monotonic() - 1.0)   # already late
    eng.observe("c", np.full(2, 0.5), 1.0)
    eng.add_study("d", deadline=time.monotonic() + 60.0)  # can wait
    eng.observe("d", np.full(2, 0.5), 1.0)
    eng.step()
    assert eng.study_state("c")[0] == "shed"
    assert eng.study_state("d")[0] == "queued"
    with pytest.raises(FleetStudyError, match="shed"):
        eng.request_suggest("c")
    assert eng.stats_snapshot()["n_shed"] == 1


# ===================================================== Schur fallback
def test_incremental_update_genuine_ill_conditioned_schur():
    """A duplicate point at (near-)zero noise: ok flips False; a
    well-separated append at the same θ stays ok.  Also per slot: the
    stacked update flags each slot on its own."""
    rng = np.random.default_rng(0)
    b, D, n0 = 8, 2, 5
    p = KernelParams(log_lengthscale=torch.zeros(D, dtype=torch.float64),
                     log_amplitude=torch.tensor(0.0, dtype=torch.float64),
                     log_noise=torch.tensor(-35.0, dtype=torch.float64))
    x = torch.tensor(rng.uniform(0, 1, (b, D)))
    yv = torch.tensor(np.sin(3 * x.numpy()).sum(1))
    v = torch.arange(b) < n0
    K = gram(x, p, "matern52", jitter=0.0)
    K = torch.where(v[:, None] & v[None, :], K, torch.eye(b,
                                                          dtype=K.dtype))
    chol = torch.linalg.cholesky(K)
    ys, _, _ = standardize_masked(yv * v, v)
    assert bool(incremental_update(x, ys, n0 + 1, p, chol, jitter=0.0)[3])
    x_dup = x.clone()
    x_dup[n0] = x[2]
    assert not bool(incremental_update(x_dup, ys, n0 + 1, p, chol,
                                       jitter=0.0)[3])
    pp = KernelParams(*(t.expand((2,) + t.shape) for t in (
        p.log_lengthscale, p.log_amplitude, p.log_noise)))
    ok = incremental_update(torch.stack([x, x_dup]), torch.stack([ys, ys]),
                            torch.tensor([n0 + 1, n0 + 1]), pp,
                            torch.stack([chol, chol]), jitter=0.0)[3]
    assert ok.tolist() == [True, False]


def test_injected_fallback_matches_scheduled_full_refit():
    """Vetoing the incremental ok reproduces a refit_interval=1 engine
    bitwise (the fallback IS a full refit) and shows in EngineStats."""
    rng = np.random.default_rng(2)
    D = 3
    mso = LbfgsbOptions(maxiter=40, pgtol=1e-2)
    inj = FaultInjector(incr_fail={None: 999})
    kw = dict(dim=D, n_restarts=4, pad_bucket=8, warm_start=False, mso=mso)
    a = AskEngine(EvalEngine(logei_acq, "cpu"),
                  AskConfig(refit_interval=8, **kw), fault_injector=inj)
    b = AskEngine(EvalEngine(logei_acq, "cpu"),
                  AskConfig(refit_interval=1, **kw))
    for _ in range(5):
        xi = rng.uniform(0, 1, D)
        a.observe(xi, _sphere(xi))
        b.observe(xi, _sphere(xi))
    kinds = []
    for t in range(4):
        draws = default_draws(0, t, 3, D)
        bxa, ia = a.suggest(draws, fit_seed=t)
        bxb, _ = b.suggest(draws, fit_seed=t)
        np.testing.assert_array_equal(bxa, bxb, err_msg=f"trial {t}")
        kinds.append(ia.kind)
        xn = np.clip(bxa, 0, 1)
        a.observe(xn, _sphere(xn))
        b.observe(xn, _sphere(xn))
    assert kinds == ["full"] + ["fallback"] * 3
    assert a.n_fallbacks == 3 and a.n_incremental == 0
    assert a.engine.stats_snapshot()["n_refit_fallbacks"] == 3
    assert inj.n_incr_vetoed == 3


# ============================================== crash recovery (chaos)
@pytest.fixture(scope="module")
def uninterrupted():
    """The twin the recovered runs are held against: 2 studies, 12
    rounds across the 8 → 16 bucket, cold refits."""
    ref = FleetSampler([BoxSpace.cube(3, 0.0, 1.0)] * 2, seed=0,
                       **_fleet_kw())
    _drive(ref, 12)
    return ref


@pytest.mark.parametrize("kill_at", [9, 26, 41])
def test_crash_recovery_bitwise_per_study_trajectories(tmp_path,
                                                       uninterrupted,
                                                       kill_at):
    """Kill the process (injected) at a journal offset: in the random
    startup (9), past a checkpoint in the suggest phase (26, 41); recover;
    each study's suggestions match the uninterrupted twin bitwise
    (refit_interval=1, no warm start), through a bucket migration."""
    d = str(tmp_path)
    sp = BoxSpace.cube(3, 0.0, 1.0)
    rounds = 12
    vic = FleetSampler([sp] * 2, seed=0, journal_dir=d,
                       fault_injector=FaultInjector(kill_at_seq=kill_at),
                       **_fleet_kw())
    with pytest.raises(InjectedCrash):
        for r in range(rounds):
            if r == 3:
                vic.checkpoint()         # replay starts mid-journal
            _drive(vic, 1)
    with pytest.warns(UserWarning, match="dropping"):
        fs, rep = FleetSampler.recover(d, device="cpu")
    assert rep.truncated_bytes > 0 and rep.n_replayed > 0
    assert (rep.snapshot_step is not None) == (kill_at > 20)
    for i, tid in rep.pending:           # asked, never told: re-evaluate
        fs.tell(i, tid, _sphere(fs.samplers[i].trials[tid].x))
    done = min(len(s.trials) for s in fs.samplers)
    _drive(fs, rounds - done + 1)
    for i in range(2):
        a, b = uninterrupted.samplers[i].trials, fs.samplers[i].trials
        n = min(len(a), len(b))
        assert n >= rounds
        for k in range(n):
            np.testing.assert_array_equal(a[k].x, b[k].x,
                                          err_msg=f"study {i} trial {k}")
    assert fs.stats_snapshot()["n_fleet_compiles"] <= 3 * 2


def test_sigterm_drain_checkpoint_and_recover(tmp_path):
    """SIGUSR1 (the SIGTERM handler) during optimize(): the round in
    flight finishes, the fleet drains (checkpoint, journal, close), and
    recover() restores trial state and warm-start θ exactly."""
    d = str(tmp_path)
    sp = BoxSpace.cube(3, 0.0, 1.0)
    fs = FleetSampler([sp] * 2, seed=1, journal_dir=d,
                      **_fleet_kw(warm_start=True))
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        flag = fs.install_drain_handler()
        _drive(fs, 6)
        theta = {i: np.array(fs.fleet.study_theta(i)) for i in range(2)}
        os.kill(os.getpid(), signal.SIGUSR1)
        assert flag.triggered
        fs.optimize(_sphere, 5)          # drains at the round boundary
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert fs.journal._f is None
    recs = _journal_records(d)
    assert recs[-1]["op"] == "drain"
    assert any(r["op"] == "refit" for r in recs)
    fs2, rep = FleetSampler.recover(d, device="cpu")
    assert rep.pending == [] and rep.truncated_bytes == 0
    for i in range(2):
        a, b = fs.samplers[i].trials, fs2.samplers[i].trials
        assert [(t.trial_id, t.state) for t in a] == \
            [(t.trial_id, t.state) for t in b]
        for ta, tb in zip(a, b):
            np.testing.assert_array_equal(ta.x, tb.x)
        np.testing.assert_array_equal(theta[i], fs2.fleet.study_theta(i))


# ========================================== quarantine / park (chaos)
def test_quarantine_keeps_far_invariant_and_compile_economy(tmp_path):
    """An injected unhealthy full refit quarantines the newest observation
    (journaled, Trial marked), resets its slot row to the idle pattern,
    and the retry reuses the same programs."""
    d = str(tmp_path)
    sp = BoxSpace.cube(3, 0.0, 1.0)
    inj = FaultInjector(full_fail={1: 1})
    fs = FleetSampler([sp] * 2, seed=2, journal_dir=d, fault_injector=inj,
                      **_fleet_kw())
    _drive(fs, 7)
    assert inj.n_full_vetoed == 1
    snap = fs.stats_snapshot()
    assert snap["n_quarantined"] == 1 and snap["n_parked"] == 0
    q = [r for r in _journal_records(d) if r["op"] == "quarantine"]
    assert len(q) == 1 and q[0]["sid"] == 1
    t = fs.samplers[1].trials[q[0]["trial"]]
    assert t.state == "quarantined" and "unhealthy" in t.error
    st = fs.fleet._studies[1]
    blk, slot, n = st.block, st.slot, st.n
    np.testing.assert_array_equal(blk.x[slot, n:].numpy(), blk.idle_x[n:])
    np.testing.assert_array_equal(blk.y[slot, n:].numpy(),
                                  np.zeros(blk.bucket - n))
    assert snap["n_fleet_compiles"] <= 3
    assert len(fs.samplers[1].trials) == len(fs.samplers[0].trials)


def test_park_after_quarantine_exhaustion_degrades_to_solo():
    """Persistent unhealthy refits exhaust the quarantine budget: the
    study is parked and goes on solo; the rest of the fleet is untouched;
    backoff sleeps go through the sleep hook."""
    from faults import VirtualClock
    sp = BoxSpace.cube(3, 0.0, 1.0)
    clock = VirtualClock()
    inj = FaultInjector(full_fail={1: 99})
    fs = FleetSampler([sp] * 2, seed=3, quarantine_retries=1,
                      fault_injector=inj, retry_backoff_base=0.5,
                      sleep_fn=clock.sleep, **_fleet_kw())
    _drive(fs, 8)
    snap = fs.stats_snapshot()
    assert snap["n_parked"] == 1 and snap["n_quarantined"] == 2
    assert snap["n_degraded"] == 1
    assert snap["n_retry_backoffs"] == 1 and clock.n_sleeps == 1
    assert 0.5 <= clock.slept_s <= 0.5 * 1.25
    s1 = fs.samplers[1]
    assert s1.degraded is not None and "parked" in s1.degraded
    assert s1._fleet is None
    assert len(s1.trials) == len(fs.samplers[0].trials) == 8
    assert fs.samplers[0].degraded is None
    fs.samplers[0].best()


# ========================================== files of the JAX package
@pytest.fixture(scope="module")
def jax_journal(tmp_path_factory):
    """A journal, snapshot included, written by JAX's FleetSampler (xla
    backend), and a GPSampler.save file of one of its studies."""
    d = str(tmp_path_factory.mktemp("jax_journal"))
    js = JFleetSampler([JBox.cube(2, 0.0, 1.0)] * 2, seed=3, journal_dir=d,
                       n_startup_trials=4, n_restarts=4, pad_multiple=8,
                       slots=2, posterior_backend="xla", refit_interval=1,
                       warm_start=False, mso_options=JOpts(**_MSO))
    for r in range(7):
        if r == 5:
            js.checkpoint()
        trials = js.ask_all()
        for i, t in enumerate(trials):
            if (r, i) == (6, 1):
                js.tell(i, t.trial_id, 0.0, failed=True, error="boom")
            else:
                js.tell(i, t.trial_id, _sphere(t.x))
    js.journal.close()
    path = os.path.join(d, "study1.json")
    js.samplers[1].save(path)
    return d, js, path


def test_jax_journal_replays_and_recovers_in_the_port(jax_journal):
    """The port reads a journal the JAX package wrote record for record,
    and recover() rebuilds every study's trials from it and its
    checkpoint: same x, y and states; the recovered fleet asks on."""
    d, js, _ = jax_journal
    assert StudyJournal(d).replay() == JStudyJournal(d).replay()
    fs, rep = FleetSampler.recover(d, device="cpu")
    assert rep.snapshot_step is not None and rep.pending == []
    assert fs.fleet.cfg.backend == "cholesky"
    for a, b in zip(js.samplers, fs.samplers):
        assert [(t.trial_id, t.state, t.y, t.error) for t in a.trials] == \
            [(t.trial_id, t.state, t.y, t.error) for t in b.trials]
        for ta, tb in zip(a.trials, b.trials):
            np.testing.assert_array_equal(ta.x, tb.x)
    trials = fs.ask_all()
    assert [t.trial_id for t in trials] == [7, 7]


def test_jax_sampler_save_loads_in_the_port_and_back(jax_journal,
                                                     tmp_path):
    """GPSampler.save of the JAX package loads in the port with the same
    trials (a pending one marked failed), and the port's file loads in
    the JAX package."""
    _, js, path = jax_journal
    s = GPSampler.load(path, device="cpu")
    src = js.samplers[1]
    assert s.seed == src.seed and s.strategy == src.strategy
    np.testing.assert_array_equal(s.space.lower, src.space.lower)
    assert [(t.trial_id, t.y, t.state, t.error) for t in s.trials] == \
        [(t.trial_id, t.y, t.state, t.error) for t in src.trials]
    pending = s.ask()                    # never told: failed on reload
    s.save(str(tmp_path / "port.json"))
    back = JSampler.load(str(tmp_path / "port.json"))
    assert back.trials[-1].trial_id == pending.trial_id
    assert back.trials[-1].state == "failed"
    assert [t.y for t in back.trials[:-1]] == [t.y for t in s.trials[:-1]]
