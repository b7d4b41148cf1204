"""The port's BO service (``repro_torch/serve/bo_service.py``): held against
the JAX package's ``BOService`` on the same scripted traffic (journal
records op for op, suggestions to 1e-10, backoff delays bitwise), each
package recovering the other's service journal, and, within the port, the
checks of the reference's ``tests/test_service.py``: DRR fairness, one
in-flight ask per study, deadlines, bounded retry backoff, the overload
ladder, the tenant queue cap, NaN-tell spam, drain and recovery, the async
facade and out-of-order tells.

Everything timing-related runs on ``tests/faults.py``'s VirtualClock; the
JAX side runs its ``"xla"`` backend, the port its ``"cholesky"`` on the
CPU, with JAX's θ-grid and restart draws injected where the two packages
are compared."""
import asyncio
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from faults import FaultInjector, VirtualClock  # noqa: E402
from repro.bo.journal import InjectedCrash as JInjectedCrash  # noqa: E402
from repro.bo.sampler import FleetSampler as JFleetSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.serve.bo_service import BOService as JBOService  # noqa: E402
from repro.serve.bo_service import TenantConfig as JTenant  # noqa: E402
from repro_torch.bo.journal import InjectedCrash, StudyJournal  # noqa: E402
from repro_torch.bo.sampler import FleetSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.engine.fleet import FleetFullError  # noqa: E402
from repro_torch.serve.bo_service import (BOService,  # noqa: E402
                                          DeadlineExceeded, OverloadConfig,
                                          RequestFailed, ServiceDraining,
                                          TenantConfig, TenantShedError)

_MSO = dict(maxiter=40, pgtol=1e-2)
# the fields of a service record both packages must agree on
_SVC_KEYS = ("op", "req", "tenant", "study", "rung", "reason")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor ops: one intra-op thread a test process,
    so that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(x):
    return float(np.sum((x - 0.4) ** 2))


def _jax_restart_draws(seed, n_trials, B=4, D=2):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), n_trials)
    return np.asarray(jax.random.uniform(key, (B - 1, D), jnp.float64))


def _jax_theta_draws(fit_seed, restarts=2, D=2):
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(fit_seed), (restarts - 1, D + 2), jnp.float64,
        minval=-1.0, maxval=1.0))


def _fleet_kw(**over):
    kw = dict(n_startup_trials=4, n_restarts=4, pad_multiple=8, slots=4,
              posterior_backend="cholesky", refit_interval=1,
              warm_start=False, mso_options=MsoOptions(**_MSO),
              device="cpu")
    kw.update(over)
    return kw


def _journal_records(d):
    path = os.path.join(d, "journal.log")
    return StudyJournal._scan_and_truncate(path, truncate=False)[0]


def _mk_service(n_studies, tenants, *, journal_dir=None, fi=None,
                clock=None, fleet_over=None, jax_draws=False, **svc_kw):
    clock = clock if clock is not None else VirtualClock()
    draws = (dict(theta_draws=_jax_theta_draws,
                  restart_draws=_jax_restart_draws) if jax_draws else {})
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * n_studies, seed=0,
                      journal_dir=journal_dir, fault_injector=fi,
                      sleep_fn=clock.sleep,
                      **_fleet_kw(**(fleet_over or {})), **draws)
    return BOService(fs, tenants, clock=clock, **svc_kw), clock


def _mk_jax_service(n_studies, tenants, *, journal_dir=None, fi=None,
                    **svc_kw):
    clock = VirtualClock()
    fs = JFleetSampler([JBox.cube(2, 0.0, 1.0)] * n_studies, seed=0,
                       journal_dir=journal_dir, fault_injector=fi,
                       sleep_fn=clock.sleep, n_startup_trials=4,
                       n_restarts=4, pad_multiple=8, slots=4,
                       posterior_backend="xla", refit_interval=1,
                       warm_start=False, mso_options=JOpts(**_MSO))
    return JBOService(fs, tenants, clock=clock, **svc_kw), clock


def _serve(svc, reqs, max_steps=50):
    for _ in range(max_steps):
        if all(r.done for r in reqs):
            return
        svc.service_step()
    raise AssertionError(
        f"requests not served: {[(r.rid, r.state) for r in reqs]}")


_SCRIPT_TENANTS = [TenantConfig("a", weight=2.0, studies=(0,)),
                   TenantConfig("b", weight=1.0, studies=(1,))]
_J_SCRIPT_TENANTS = [JTenant("a", weight=2.0, studies=(0,)),
                     JTenant("b", weight=1.0, studies=(1,))]


def _run_script(svc, rounds):
    """The scripted workload of the reference's service tests: one ask per
    tenant per round, served then told (either package's service)."""
    for r in range(rounds):
        if r == 3 and svc.fs.ckpt is not None:
            svc.fs.checkpoint()            # replay starts mid-journal
        reqs = [svc.submit_ask("a", 0), svc.submit_ask("b", 1)]
        _serve(svc, reqs)
        for req in reqs:
            svc.submit_tell(req.tenant, req.study, req.result.trial_id,
                            _sphere(req.result.x))


def _svc_view(records):
    return [tuple(r.get(k) for k in _SVC_KEYS) for r in records
            if r["op"].startswith("svc_")]


# ================================================== against the JAX one
@pytest.fixture(scope="module")
def jax_script_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_svc"))
    svc, _ = _mk_jax_service(2, _J_SCRIPT_TENANTS, journal_dir=d)
    _run_script(svc, 6)
    return d, [[np.array(t.x) for t in s.trials] for s in svc.fs.samplers]


def test_scripted_traffic_matches_jax_service(tmp_path, jax_script_run):
    """The same scripted traffic through both packages' services: the same
    journal, op for op (every ``svc_*`` record's op, req, tenant, study,
    rung and reason), and the same suggestions to 1e-10 (JAX's draws
    injected)."""
    jd, jx = jax_script_run
    d = str(tmp_path)
    svc, _ = _mk_service(2, _SCRIPT_TENANTS, journal_dir=d, jax_draws=True)
    _run_script(svc, 6)
    jrec, trec = _journal_records(jd), _journal_records(d)
    assert [r["op"] for r in trec] == [r["op"] for r in jrec]
    assert _svc_view(trec) == _svc_view(jrec)
    assert len(_svc_view(trec)) == 1 + 6 * 6
    assert trec[0] == jrec[0]              # the fleet's config record
    cfg = [r for r in trec if r["op"] == "svc_config"][0]
    jcfg = [r for r in jrec if r["op"] == "svc_config"][0]
    assert cfg == jcfg
    for i in range(2):
        xt = np.array([t.x for t in svc.fs.samplers[i].trials])
        assert xt.shape == (6, 2)
        np.testing.assert_allclose(xt, np.array(jx[i]), rtol=0, atol=1e-10)


def test_backoff_delays_bitwise_jax_service(tmp_path):
    """Injected dispatch failures through both services: the same
    ``svc_retry`` records (attempt, delay, eligibility time), bitwise —
    one fixed-seed jitter stream and one virtual time base."""
    def run(svc, clock):
        req = svc.submit_ask("a", 0)
        for _ in range(20):
            if req.done:
                break
            svc.service_step()
            clock.advance(0.5)
        assert req.done and req.result is not None and req.attempts == 4

    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    run(*_mk_jax_service(1, [JTenant("a", studies=(0,))], journal_dir=jd,
                         fi=FaultInjector(ask_fail={0: 3}), max_retries=5))
    run(*_mk_service(1, [TenantConfig("a", studies=(0,))], journal_dir=td,
                     fi=FaultInjector(ask_fail={0: 3}), max_retries=5))
    keep = ("attempt", "delay_s", "not_before", "error")
    jr = [tuple(r[k] for k in keep) for r in _journal_records(jd)
          if r["op"] == "svc_retry"]
    tr = [tuple(r[k] for k in keep) for r in _journal_records(td)
          if r["op"] == "svc_retry"]
    assert len(tr) == 3 and tr == jr
    assert _svc_view(_journal_records(td)) == _svc_view(
        _journal_records(jd))


def _recovered_view(svc, rep):
    queued = [(r.rid, r.tenant, r.study) for r in svc.recovered["queued"]]
    ready = [(r.rid, r.tenant, r.study, r.result.trial_id,
              tuple(np.asarray(r.result.x).tolist()))
             for r in svc.recovered["ready"]]
    return queued, ready, sorted(rep.pending)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_service_journal_recovers_in_the_other_package(tmp_path, writer):
    """A service killed mid-journal (at the record that would deliver the
    first GP suggestion, one ask journaled and one still queued) by one
    package recovers in the other: the same restored queue (rid, tenant,
    study), the same ready results and the same pending trials as the
    writer's own recover gives."""
    d = str(tmp_path / "w")
    kill = 49               # round 4's first svc_done (max_batch=1)
    if writer == "jax":
        svc, _ = _mk_jax_service(2, _J_SCRIPT_TENANTS, journal_dir=d,
                                 fi=FaultInjector(kill_at_seq=kill),
                                 max_batch=1)
        crash = JInjectedCrash
    else:
        svc, _ = _mk_service(2, _SCRIPT_TENANTS, journal_dir=d,
                             fi=FaultInjector(kill_at_seq=kill),
                             max_batch=1, jax_draws=True)
        crash = InjectedCrash
    with pytest.raises(crash):
        _run_script(svc, 6)
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(d, dj)
    shutil.copytree(d, dt)
    with pytest.warns(UserWarning, match="dropping"):
        jsvc, jrep = JBOService.recover(dj, clock=VirtualClock())
    with pytest.warns(UserWarning, match="dropping"):
        tsvc, trep = BOService.recover(dt, device="cpu",
                                       clock=VirtualClock())
    assert tsvc.fs.fleet.cfg.backend == "cholesky"
    assert jsvc.fs.samplers[0].posterior_backend == "xla"
    jq, jr, jp = _recovered_view(jsvc, jrep)
    tq, tr, tp = _recovered_view(tsvc, trep)
    assert (tq, tr, tp) == (jq, jr, jp)
    assert len(tq) == 1 and len(tr) == 1
    assert tsvc._req_seq == jsvc._req_seq
    with pytest.raises(NotImplementedError, match="9b"):
        BOService.recover(dt, device="cpu", mesh=object())


# ============================================= DRR fairness / starvation
def test_drr_weighted_fairness_and_no_starvation():
    svc, _ = _mk_service(4, [
        TenantConfig("heavy", weight=2.0, studies=(0, 1)),
        TenantConfig("light", weight=1.0, studies=(2,)),
        TenantConfig("slow", weight=0.5, studies=(3,)),
    ])
    flood = [svc.submit_ask("heavy", s) for _ in range(6) for s in (0, 1)]
    for rnd in range(8):
        light = svc.submit_ask("light", 2)
        svc.submit_ask("slow", 3)
        svc.service_step()
        assert light.done and light.result is not None, \
            f"round {rnd}: light starved ({light.state})"
    assert all(r.done for r in flood)
    snap = svc.stats_snapshot()["svc_tenants"]
    assert snap["heavy"]["served"] == 12
    assert snap["light"]["served"] == 8
    assert 3 <= snap["slow"]["served"] <= 4
    assert svc.n_shed == 0 and svc.n_rejected == 0


def test_drr_one_inflight_per_study_per_round():
    svc, _ = _mk_service(1, [TenantConfig("a", studies=(0,))])
    r1, r2 = svc.submit_ask("a", 0), svc.submit_ask("a", 0)
    assert svc.service_step() == 1
    assert r1.done and not r2.done
    assert svc.service_step() == 1
    assert r2.done
    assert r1.result.trial_id != r2.result.trial_id


# ============================================================ deadlines
def test_deadline_shed_while_queued(tmp_path):
    d = str(tmp_path)
    svc, clock = _mk_service(2, [TenantConfig("a", studies=(0, 1))],
                             journal_dir=d)
    req = svc.submit_ask("a", 0, deadline=0.5)
    ok = svc.submit_ask("a", 1, deadline=10.0)
    clock.advance(1.0)
    svc.service_step()
    assert req.state == "shed" and isinstance(req.error, DeadlineExceeded)
    assert ok.done and ok.result is not None
    snap = svc.stats_snapshot()
    assert snap["svc_deadline_miss"] == 1 and snap["svc_shed"] == 1
    recs = [r for r in _journal_records(d) if r["op"] == "svc_shed"]
    assert len(recs) == 1 and recs[0]["req"] == req.rid
    assert recs[0]["kind"] == "deadline" and "queued" in recs[0]["reason"]
    again = svc.submit_ask("a", 0)
    svc.service_step()
    assert again.done and again.result is not None


def test_deadline_miss_in_flight_via_injected_latency(tmp_path):
    """A suggestion that comes back after its deadline (injected full-refit
    latency, charged through the fleet's sleep hook to the service's
    clock) is shed: the trial stays pending, the shed is journaled."""
    d = str(tmp_path)
    fi = FaultInjector()
    svc, clock = _mk_service(2, [TenantConfig("a", studies=(0,)),
                                 TenantConfig("b", studies=(1,))],
                             journal_dir=d, fi=fi)
    for _ in range(5):
        reqs = [svc.submit_ask("a", 0), svc.submit_ask("b", 1)]
        _serve(svc, reqs)
        for r in reqs:
            svc.submit_tell(r.tenant, r.study, r.result.trial_id,
                            _sphere(r.result.x))
    n_before = len(svc.fs.samplers[0].trials)
    fi.full_latency[0] = [10.0, 1]
    late = svc.submit_ask("a", 0, deadline=5.0)
    intime = svc.submit_ask("b", 1, deadline=100.0)
    _serve(svc, [late, intime])
    assert late.state == "shed" and isinstance(late.error, DeadlineExceeded)
    assert "in flight" in str(late.error)
    assert intime.done and intime.result is not None
    assert fi.n_full_delays == 1 and clock.slept_s >= 10.0
    assert svc.fs.samplers[0].trials[n_before].state == "pending"
    recs = [r for r in _journal_records(d) if r["op"] == "svc_shed"]
    assert len(recs) == 1 and recs[0]["req"] == late.rid


# ====================================================== backoff retries
def test_transient_dispatch_failure_retries_with_bounded_backoff(tmp_path):
    d = str(tmp_path)
    svc, clock = _mk_service(
        1, [TenantConfig("a", studies=(0,))], journal_dir=d,
        fi=FaultInjector(ask_fail={0: 3}), max_retries=5,
        backoff_base=0.1, backoff_cap=0.25, backoff_jitter=0.25)
    req = svc.submit_ask("a", 0)
    for _ in range(20):
        if req.done:
            break
        svc.service_step()
        clock.advance(0.5)
    assert req.done and req.result is not None and req.attempts == 4
    recs = [r for r in _journal_records(d) if r["op"] == "svc_retry"]
    assert [r["attempt"] for r in recs] == [1, 2, 3]
    for i, r in enumerate(recs):
        base = min(0.1 * 2.0 ** i, 0.25)
        assert base <= r["delay_s"] <= base * 1.25
    assert recs[0]["delay_s"] < recs[1]["delay_s"]
    snap = svc.stats_snapshot()
    assert snap["svc_retries"] == 3 and snap["svc_shed"] == 0


def test_retry_exhaustion_fails_request_and_isolates_tenant(tmp_path):
    d = str(tmp_path)
    svc, clock = _mk_service(
        2, [TenantConfig("a", studies=(0,)), TenantConfig("b",
                                                          studies=(1,))],
        journal_dir=d, fi=FaultInjector(ask_fail={0: 99}), max_retries=2,
        backoff_base=0.01, backoff_cap=0.02)
    bad, good = svc.submit_ask("a", 0), svc.submit_ask("b", 1)
    for _ in range(20):
        if bad.done and good.done:
            break
        svc.service_step()
        clock.advance(0.1)
    assert good.done and good.result is not None
    assert bad.state == "failed" and isinstance(bad.error, RequestFailed)
    assert bad.attempts == 3
    recs = [r for r in _journal_records(d) if r["op"] == "svc_shed"]
    assert len(recs) == 1 and recs[0]["kind"] == "failed"
    assert "retries exhausted" in recs[0]["reason"]


def test_backoff_delays_deterministic_across_runs(tmp_path):
    def run(sub):
        d = str(tmp_path / sub)
        svc, clock = _mk_service(
            1, [TenantConfig("a", studies=(0,))], journal_dir=d,
            fi=FaultInjector(ask_fail={0: 3}), max_retries=5)
        req = svc.submit_ask("a", 0)
        for _ in range(20):
            if req.done:
                break
            svc.service_step()
            clock.advance(1.0)
        return [r["delay_s"] for r in _journal_records(d)
                if r["op"] == "svc_retry"]
    a, b = run("a"), run("b")
    assert len(a) == 3 and a == b


# ======================================================= overload ladder
def test_overload_reject_rung_and_deescalation(tmp_path):
    d = str(tmp_path)
    svc, _ = _mk_service(
        2, [TenantConfig("a", studies=(0,)), TenantConfig("b",
                                                          studies=(1,))],
        journal_dir=d, overload=OverloadConfig(reject_depth=3,
                                               degrade_depth=50,
                                               shed_depth=60))
    backlog = [svc.submit_ask("a", 0) for _ in range(3)]
    svc.service_step()
    assert svc.stats_snapshot()["svc_rung"] == "reject"
    with pytest.raises(FleetFullError, match="rung reject"):
        svc.submit_ask("b", 1)
    assert svc.stats_snapshot()["svc_tenants"]["b"]["rejected"] == 1
    _serve(svc, backlog)
    svc.service_step()
    assert svc.stats_snapshot()["svc_rung"] == "admit"
    ok = svc.submit_ask("b", 1)
    svc.service_step()
    assert ok.done and ok.result is not None
    rungs = [(r["from"], r["rung"]) for r in _journal_records(d)
             if r["op"] == "svc_overload"]
    assert rungs == [("admit", "reject"), ("reject", "admit")]


def test_overload_degrade_and_shed_lowest_weight_tenant(tmp_path):
    """Degrade moves the lowest-weight tenant's study off the fleet onto
    the solo fused AskEngine (it keeps being served there), then shed
    drops it; the journal shows the transition before its effects."""
    d = str(tmp_path)
    svc, _ = _mk_service(
        3, [TenantConfig("gold", weight=4.0, studies=(0,)),
            TenantConfig("silver", weight=2.0, studies=(1,)),
            TenantConfig("bronze", weight=1.0, studies=(2,))],
        journal_dir=d, overload=OverloadConfig(reject_depth=4,
                                               degrade_depth=6,
                                               shed_depth=50))
    for _ in range(4):                     # past startup: GP asks
        reqs = [svc.submit_ask(t, s) for t, s in
                (("gold", 0), ("silver", 1), ("bronze", 2))]
        _serve(svc, reqs)
        for r in reqs:
            svc.submit_tell(r.tenant, r.study, r.result.trial_id,
                            _sphere(r.result.x))
    backlog = [svc.submit_ask("gold", 0) for _ in range(3)]
    solo = [svc.submit_ask("bronze", 2) for _ in range(3)]
    svc.service_step()                     # depth 6 >= 6: degrade bronze
    snap = svc.stats_snapshot()
    assert snap["svc_rung"] == "degrade" and snap["n_degraded"] == 1
    assert snap["svc_tenants"]["bronze"]["degraded"]
    s2 = svc.fs.samplers[2]
    assert s2._fleet is None and s2._ask is not None   # solo fused ask
    assert svc.fs.samplers[0]._fleet is not None
    _serve(svc, backlog + solo)
    assert all(r.result is not None for r in solo)
    assert s2.last_ask_info.kind in ("full", "incremental", "fallback")
    # straight from admit to shed_tenant: rung 2 degrades the lowest
    # weight not yet degraded (silver), rung 3 sheds the lowest standing
    svc.overload = OverloadConfig(reject_depth=2, degrade_depth=4,
                                  shed_depth=6)
    more = [svc.submit_ask("gold", 0) for _ in range(3)]
    more += [svc.submit_ask("bronze", 2) for _ in range(3)]
    victim = svc.submit_ask("bronze", 2)
    svc.service_step()
    t = svc.stats_snapshot()["svc_tenants"]
    assert svc.stats_snapshot()["svc_rung"] == "shed_tenant"
    assert t["bronze"]["is_shed"] and not t["gold"]["is_shed"]
    assert t["silver"]["degraded"] and not t["silver"]["is_shed"]
    assert svc.fs.samplers[1]._fleet is None
    assert victim.state == "shed" and isinstance(victim.error,
                                                 TenantShedError)
    with pytest.raises(TenantShedError):
        svc.submit_ask("bronze", 2)
    with pytest.raises(TenantShedError):
        svc.submit_tell("bronze", 2, 0, 1.0)
    recs = _journal_records(d)
    ops = [r["op"] for r in recs]
    assert ops.index("svc_overload") < ops.index("svc_degrade") \
        < ops.index("svc_shed_tenant")
    shd = [r for r in recs if r["op"] == "svc_shed_tenant"]
    assert len(shd) == 1 and victim.rid in shd[0]["dropped"]
    _serve(svc, [r for r in more if r.tenant == "gold"])
    svc.service_step()
    assert svc.stats_snapshot()["svc_rung"] == "admit"


def test_tenant_shed_resolves_backoff_delayed_requests(tmp_path):
    d = str(tmp_path)
    svc, _ = _mk_service(
        2, [TenantConfig("big", weight=2.0, studies=(0,)),
            TenantConfig("small", weight=1.0, studies=(1,))],
        journal_dir=d, fi=FaultInjector(ask_fail={1: 99}),
        overload=OverloadConfig(reject_depth=2, degrade_depth=4,
                                shed_depth=6))
    stuck = svc.submit_ask("small", 1)
    svc.service_step()
    assert stuck.state == "delayed"
    backlog = [svc.submit_ask("big", 0) for _ in range(6)]
    svc.service_step()
    assert svc.stats_snapshot()["svc_rung"] == "shed_tenant"
    assert stuck.state == "shed" and isinstance(stuck.error,
                                                TenantShedError)
    snap = svc.stats_snapshot()["svc_tenants"]["small"]
    assert snap["shed"] == 1 and snap["is_shed"]
    shd = [r for r in _journal_records(d) if r["op"] == "svc_shed_tenant"]
    assert len(shd) == 1 and stuck.rid in shd[0]["dropped"]
    _serve(svc, backlog)


def test_p99_rung_deescalates_after_queue_drains(tmp_path):
    d = str(tmp_path)
    svc, clock = _mk_service(
        1, [TenantConfig("a", studies=(0,))], journal_dir=d,
        overload=OverloadConfig(reject_depth=1000, p99_slo=0.6,
                                min_samples=3, window=8))
    for _ in range(3):
        req = svc.submit_ask("a", 0)
        clock.advance(1.0)
        svc.service_step()
        assert req.done and req.result is not None
    assert svc.p99() >= 1.0
    queued = svc.submit_ask("a", 0)
    svc.service_step()
    assert queued.done
    assert svc.stats_snapshot()["svc_rung"] == "reject"
    with pytest.raises(FleetFullError, match="p99"):
        svc.submit_ask("a", 0)
    svc.service_step()
    assert svc.stats_snapshot()["svc_rung"] == "admit"
    rungs = [(r["from"], r["rung"]) for r in _journal_records(d)
             if r["op"] == "svc_overload"]
    assert rungs[:2] == [("admit", "reject"), ("reject", "admit")]


def test_tenant_queue_cap_isolates_backlog_spam():
    svc, _ = _mk_service(
        2, [TenantConfig("spam", studies=(0,)), TenantConfig("calm",
                                                             studies=(1,))],
        overload=OverloadConfig(reject_depth=100, tenant_queue_cap=2))
    for _ in range(2):
        svc.submit_ask("spam", 0)
    with pytest.raises(FleetFullError, match="backlog"):
        svc.submit_ask("spam", 0)
    ok = svc.submit_ask("calm", 1)
    svc.service_step()
    assert ok.done and ok.result is not None


def test_nan_tell_spam_costs_only_the_spammer(tmp_path):
    d = str(tmp_path)
    svc, _ = _mk_service(2, [TenantConfig("spam", studies=(0,)),
                             TenantConfig("calm", studies=(1,))],
                         journal_dir=d)
    t = svc.submit_ask("spam", 0)
    svc.service_step()
    n_recs = len(_journal_records(d))
    for _ in range(5):
        with pytest.raises(ValueError, match="failed=True"):
            svc.submit_tell("spam", 0, t.result.trial_id, float("nan"))
    assert len(_journal_records(d)) == n_recs
    assert svc.stats_snapshot()["svc_tenants"]["spam"]["bad_tells"] == 5
    ok = svc.submit_ask("calm", 1)
    svc.service_step()
    assert ok.done and ok.result is not None


# ========================================================= drain/recover
def test_drain_journals_pending_queue_and_recover_restores_it(tmp_path):
    d = str(tmp_path)
    svc, _ = _mk_service(2, [TenantConfig("a", studies=(0,)),
                             TenantConfig("b", studies=(1,))],
                         journal_dir=d, max_batch=1)
    served = svc.submit_ask("a", 0)
    held = [svc.submit_ask("b", 1), svc.submit_ask("a", 0)]
    svc.service_step()
    assert served.done
    svc.drain()
    for r in held:
        assert r.state == "shed" and isinstance(r.error, ServiceDraining)
    recs = _journal_records(d)
    dr = [r for r in recs if r["op"] == "svc_drain"]
    assert len(dr) == 1 and dr[0]["queued"] == sorted(r.rid for r in held)
    assert recs[-1]["op"] == "drain"
    with pytest.raises(ServiceDraining):
        svc.submit_ask("a", 0)
    svc2, rep = BOService.recover(d, device="cpu", clock=VirtualClock())
    assert rep.truncated_bytes == 0
    restored = svc2.recovered["queued"]
    assert [(r.rid, r.tenant, r.study) for r in restored] == \
        [(r.rid, r.tenant, r.study) for r in held]
    _serve(svc2, restored)
    assert all(r.result is not None for r in restored)


@pytest.fixture(scope="module")
def ref_service_run():
    rounds = 6
    svc, _ = _mk_service(2, _SCRIPT_TENANTS)
    _run_script(svc, rounds)
    return rounds, [[np.array(t.x) for t in s.trials]
                    for s in svc.fs.samplers]


@pytest.mark.parametrize("kill_seq", [18, 40])
def test_service_crash_recovery_bitwise(tmp_path, ref_service_run,
                                        kill_seq):
    """Kill mid-service at a journal offset, recover; the restored queue
    re-dispatches and every study's trajectory equals the uninterrupted
    twin's bit for bit (refit_interval=1)."""
    d = str(tmp_path)
    rounds, ref_x = ref_service_run
    svc, _ = _mk_service(2, _SCRIPT_TENANTS, journal_dir=d,
                         fi=FaultInjector(kill_at_seq=kill_seq))
    with pytest.raises(InjectedCrash):
        _run_script(svc, rounds)
    with pytest.warns(UserWarning, match="dropping"):
        svc2, rep = BOService.recover(d, device="cpu", clock=VirtualClock())
    assert rep.truncated_bytes > 0
    for i, tid in rep.pending:
        svc2.submit_tell(svc2._study_owner[i], i, tid,
                         _sphere(svc2.fs.samplers[i].trials[tid].x))
    queued = svc2.recovered["queued"]
    if queued:
        _serve(svc2, queued)
        for r in queued:
            svc2.submit_tell(r.tenant, r.study, r.result.trial_id,
                             _sphere(r.result.x))
    while True:
        todo = [i for i in range(2)
                if len(svc2.fs.samplers[i].trials) < rounds]
        if not todo:
            break
        reqs = [svc2.submit_ask(svc2._study_owner[i], i) for i in todo]
        _serve(svc2, reqs)
        for r in reqs:
            svc2.submit_tell(r.tenant, r.study, r.result.trial_id,
                             _sphere(r.result.x))
    for i in range(2):
        got = svc2.fs.samplers[i].trials
        assert len(got) >= rounds
        for k in range(rounds):
            np.testing.assert_array_equal(ref_x[i][k], got[k].x,
                                          err_msg=f"study {i} trial {k}")


# ========================================================= async facade
def test_async_ask_resolves_via_event():
    svc, _ = _mk_service(1, [TenantConfig("a", studies=(0,))])

    async def main():
        server = asyncio.create_task(svc.run())
        t = await asyncio.wait_for(svc.ask("a", 0), timeout=60)
        await svc.tell("a", 0, t.trial_id, _sphere(t.x))
        svc.stop()
        await server
        return t
    t = asyncio.run(main())
    assert t is not None and svc.n_completed == 1
    assert svc.fs.samplers[0].trials[t.trial_id].state == "complete"


def test_async_ask_woken_on_shed():
    svc, clock = _mk_service(1, [TenantConfig("a", studies=(0,))],
                             fi=FaultInjector(ask_fail={0: 99}))

    async def main():
        server = asyncio.create_task(svc.run())
        task = asyncio.create_task(svc.ask("a", 0, deadline=0.01))
        for _ in range(200):
            if task.done():
                break
            clock.advance(0.02)
            await asyncio.sleep(0.002)
        with pytest.raises(DeadlineExceeded):
            await asyncio.wait_for(task, timeout=60)
        svc.stop()
        await server
    asyncio.run(main())
    assert svc.n_deadline_miss == 1


# ================================================= out-of-order tells
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_out_of_order_tells_match_direct_drive(seed):
    """The service is pure scheduling: under any tenant interleaving of
    tells (held back across round boundaries, landing after the next
    ask), per-study trajectories are bitwise those of the FleetSampler
    driven directly with the same per-study ask/tell schedule."""
    rng = np.random.default_rng(seed)
    rounds, S = 5, 2
    order = [rng.permutation(S) for _ in range(rounds)]
    hold = [int(rng.integers(0, S + 1)) for _ in range(rounds)]
    svc, _ = _mk_service(S, [TenantConfig("a", studies=(0,)),
                             TenantConfig("b", studies=(1,))],
                         fleet_over=dict(n_startup_trials=2))
    owner = {0: "a", 1: "b"}
    held = {}
    for r in range(rounds):
        reqs = [svc.submit_ask(owner[i], i) for i in range(S)]
        _serve(svc, reqs)
        for i, (tid, y) in held.items():
            svc.submit_tell(owner[i], i, tid, y)
        held = {}
        for i in order[r]:
            t = reqs[i].result
            if i == hold[r]:
                held[i] = (t.trial_id, _sphere(t.x))
            else:
                svc.submit_tell(owner[i], i, t.trial_id, _sphere(t.x))
    for i, (tid, y) in held.items():
        svc.submit_tell(owner[i], i, tid, y)

    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * S, seed=0,
                      **_fleet_kw(n_startup_trials=2))
    held = {}
    for r in range(rounds):
        trials = fs.ask_batch(range(S))
        for i, (tid, y) in held.items():
            fs.tell(i, tid, y)
        held = {}
        for i in order[r]:
            t = trials[i]
            assert not isinstance(t, Exception)
            if i == hold[r]:
                held[i] = (t.trial_id, _sphere(t.x))
            else:
                fs.tell(i, t.trial_id, _sphere(t.x))
    for i, (tid, y) in held.items():
        fs.tell(i, tid, y)
    for i in range(S):
        a, b = svc.fs.samplers[i].trials, fs.samplers[i].trials
        assert len(a) == len(b) == rounds
        for ta, tb in zip(a, b):
            np.testing.assert_array_equal(ta.x, tb.x, err_msg=f"study {i}")


def test_service_validates_tenants_and_shares_its_clock():
    """Construction refuses duplicate tenants, unowned or doubly owned
    studies and non-positive weights; the fleet's sleep hook is the
    service clock's (one time base)."""
    clock = VirtualClock()
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * 2, seed=0,
                      **_fleet_kw())
    with pytest.raises(ValueError, match="duplicate"):
        BOService(fs, [TenantConfig("a", studies=(0,)),
                       TenantConfig("a", studies=(1,))])
    with pytest.raises(ValueError, match="out of range"):
        BOService(fs, [TenantConfig("a", studies=(2,))])
    with pytest.raises(ValueError, match="owned by both"):
        BOService(fs, [TenantConfig("a", studies=(0,)),
                       TenantConfig("b", studies=(0,))])
    with pytest.raises(ValueError, match="weight"):
        TenantConfig("a", weight=0.0)
    svc = BOService(fs, [TenantConfig("a", studies=(0, 1))], clock=clock)
    assert fs.fleet._sleep == clock.sleep
    with pytest.raises(ValueError, match="study= explicitly"):
        svc.submit_ask("a")
