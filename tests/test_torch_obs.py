"""The port's telemetry plane (``repro_torch/obs``) and NaN guard
(``repro_torch/analysis``): the metrics registry and its Prometheus text
byte for byte the JAX package's; every snapshot of the port against the
port's schema, which differs from the reference's by exactly the port's
own keys; Chrome-trace export, phase breakdowns and WAL timelines equal
to the JAX package's functions on the same events and journals; the
``python -m repro_torch.obs`` CLI; and ``FiniteGuard`` on the port's
AskEngine and FleetEngine, on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faults import VirtualClock  # noqa: E402
from repro.bo.sampler import FleetSampler as JFleetSampler  # noqa: E402
from repro.bo.space import BoxSpace as JBox  # noqa: E402
from repro.core.mso import MsoOptions as JOpts  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.serve.bo_service import BOService as JBOService  # noqa: E402
from repro.serve.bo_service import TenantConfig as JTenant  # noqa: E402
from repro_torch.analysis import (FiniteGuard, NonFiniteError,  # noqa: E402
                                  install_nan_guard, nan_guard_stats)
from repro_torch.analysis.runtime import _leaves  # noqa: E402
from repro_torch.bo.sampler import FleetSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.core.acquisition import logei_acq  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402
from repro_torch.engine.ask import AskConfig, AskEngine  # noqa: E402
from repro_torch.engine.engine import EvalEngine  # noqa: E402
from repro_torch.engine.fleet import FleetConfig, FleetEngine  # noqa: E402
from repro_torch.gp.gpr import GPState  # noqa: E402
from repro_torch.gp.kernels import KernelParams  # noqa: E402
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.serve.bo_service import BOService, TenantConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MSO = dict(maxiter=40, pgtol=1e-2)
# the keys the port's snapshots carry beyond the reference's
_PORT_ONLY = {
    "eval_engine": {"kernel_launches"},
    "ask_engine": set(),
    "fleet_engine": {"n_fit_evals", "n_mso_rounds", "n_block_programs"},
    "fleet_sampler": {"kernel_launches", "n_fit_evals", "n_mso_rounds",
                      "n_block_programs"},
    "bo_service": {"kernel_launches", "n_fit_evals", "n_mso_rounds",
                   "n_block_programs"},
}


@pytest.fixture(autouse=True)
def _tracer_off_one_thread():
    """Every test starts and ends with the tracer off; one intra-op
    thread, so that parallel test workers do not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs_trace.disable()
    yield
    obs_trace.disable()
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


def _journaled_service(d, n_studies=2):
    clock = VirtualClock()
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * n_studies, seed=0,
                      journal_dir=d, sleep_fn=clock.sleep, **_fleet_kw())
    tenants = [TenantConfig("a", studies=(0,)),
               TenantConfig("b", studies=tuple(range(1, n_studies)))]
    return BOService(fs, tenants, clock=clock), clock


def _rounds(svc, n, studies=((("a", 0), ("b", 1)))):
    for _ in range(n):
        reqs = [svc.submit_ask(t, s) for t, s in studies]
        for _ in range(4):
            svc.service_step()
        assert all(r.done for r in reqs)
        for r in reqs:
            svc.submit_tell(r.tenant, r.study, r.result.trial_id,
                            _sphere(r.result.x))


# ============================================================= registry
def _drive_registry(m):
    """The same calls on either package's metrics module."""
    reg = m.MetricsRegistry()
    c = reg.counter("repro_asks", "asks served")
    c.inc(labels={"tenant": "a"})
    c.inc(2.5, labels={"tenant": "a", "study": 3})
    c.inc(labels={"tenant": "b"})
    g = reg.gauge("repro_depth")
    g.set(5)
    g.inc(-2)
    g.set(0.125, labels={"tenant": "z"})
    h = reg.histogram("repro_lat_ms", "ask latency")
    for v in (0.05, 0.7, 3.0, 3.0, 42.0, 999.0, 2e5):
        h.observe(v, labels={"tenant": "a"})
    for v in range(1, 101):
        h.observe(float(v))
    h2 = reg.histogram("repro_small", buckets=(1.0, 0.5, 2.0))
    h2.observe(0.75)
    pct = [h.percentiles(), h.percentiles(labels={"tenant": "a"}),
           h2.percentiles(), h.quantile(0.5, labels={"tenant": "q"})]
    vals = [c.value(labels={"tenant": "a"}), c.value(), g.value(),
            g.value(labels={"tenant": "z"})]
    return reg.render_prometheus(), pct, vals, reg


def test_registry_and_exposition_match_jax_byte_for_byte():
    text, pct, vals, reg = _drive_registry(obs_metrics)
    j_text, j_pct, j_vals, _ = _drive_registry(j_metrics)
    assert text == j_text
    assert pct == j_pct and vals == j_vals
    assert 'repro_asks{study="3",tenant="a"} 2.5' in text
    assert 'repro_lat_ms_bucket{le="+Inf",tenant="a"} 7' in text
    assert pct[0]["p50"] <= pct[0]["p95"] <= pct[0]["p99"]
    assert pct[3] is None
    with pytest.raises(ValueError):
        reg.counter("repro_asks").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("repro_asks")
    with pytest.raises(ValueError, match="no buckets"):
        obs_metrics.Histogram("h", buckets=())


# ====================================================== snapshot schema
def test_schema_differs_from_jax_by_the_port_keys_only():
    assert set(obs_metrics.SNAPSHOT_SCHEMAS) == set(
        j_metrics.SNAPSHOT_SCHEMAS)
    for comp, extra in _PORT_ONLY.items():
        mine = obs_metrics.SNAPSHOT_SCHEMAS[comp]
        ref = j_metrics.SNAPSHOT_SCHEMAS[comp]
        assert mine["required"] - ref["required"] == extra, comp
        assert ref["required"] <= mine["required"], comp
        assert mine["optional"] == ref["optional"], comp
    assert obs_metrics.TENANT_KEYS == j_metrics.TENANT_KEYS
    assert obs_metrics.RETRACES_KEYS == j_metrics.RETRACES_KEYS


def test_every_port_snapshot_validates(tmp_path):
    """The port's EvalEngine, AskEngine, FleetEngine, FleetSampler and
    BOService snapshots against the port's schema, before and after
    traffic: exactly the documented keys."""
    v = obs_metrics.validate_snapshot
    ev = EvalEngine(logei_acq, "cpu")
    assert v("eval_engine", ev.stats_snapshot()) == []
    ask = AskEngine(ev, AskConfig(dim=2, n_restarts=4, pad_bucket=8,
                                  refit_interval=4))
    assert v("ask_engine", ask.stats_snapshot()) == []
    fleet = FleetEngine(EvalEngine(logei_acq, "cpu"),
                        FleetConfig(dim=2, n_restarts=4, slots=2,
                                    pad_bucket=8))
    assert v("fleet_engine", fleet.stats_snapshot()) == []
    fs = FleetSampler(BoxSpace.cube(2, 0.0, 1.0), n_studies=1, seed=0,
                      **_fleet_kw())
    assert v("fleet_sampler", fs.stats_snapshot()) == []

    svc, _ = _journaled_service(str(tmp_path))
    _rounds(svc, 6)
    snap = svc.stats_snapshot()
    assert "journal_seq" in snap and snap["n_mso_rounds"] > 0
    assert v("bo_service", snap) == []
    assert v("fleet_sampler", svc.fs.stats_snapshot()) == []
    assert v("fleet_engine", svc.fs.fleet.stats_snapshot()) == []
    assert v("eval_engine", svc.fs.engine.stats_snapshot()) == []
    s0 = svc.fs.samplers[0]
    # the reference's schema refuses the port's snapshot for its 4 keys
    errs = j_metrics.validate_snapshot("bo_service", snap)
    assert len(errs) == 1 and "unexpected" in errs[0]
    for k in _PORT_ONLY["bo_service"]:
        assert k in errs[0]
    # the solo fused AskEngine of a degraded study
    s0._detach_fleet("test")
    t = s0.ask()
    assert s0._ask is not None and t.x.shape == (2,)
    assert v("ask_engine", s0._ask.stats_snapshot()) == []


def test_validate_snapshot_flags_drift():
    good = EvalEngine(logei_acq, "cpu").stats_snapshot()
    bad = dict(good)
    bad.pop("n_rounds")
    bad["n_new_thing"] = 1
    errs = obs_metrics.validate_snapshot("eval_engine", bad)
    assert any("missing" in e and "n_rounds" in e for e in errs)
    assert any("unexpected" in e and "n_new_thing" in e for e in errs)
    assert obs_metrics.validate_snapshot("nope", good)
    bad = dict(good, retraces={"causes": {}})
    assert any("retraces keys" in e for e in
               obs_metrics.validate_snapshot("eval_engine", bad))
    bad = dict(good, retraces=3)
    assert any("expected mapping" in e for e in
               obs_metrics.validate_snapshot("eval_engine", bad))
    svc_keys = (obs_metrics.FLEET_SAMPLER_KEYS | obs_metrics.SERVICE_KEYS)
    snap = {k: 0 for k in svc_keys}
    snap["retraces"] = {"causes": {}, "by_program": {}}
    snap["svc_tenants"] = {"a": {"served": 1}}
    errs = obs_metrics.validate_snapshot("bo_service", snap)
    assert len(errs) == 1 and "tenant 'a' keys differ" in errs[0]


def test_ingest_snapshot_matches_jax_exposition(tmp_path):
    """A live service snapshot ingested into either package's registry
    renders the same per-tenant and per-cause gauges (the port's dict
    keys, like the reference's, stay out of the scrape)."""
    svc, _ = _journaled_service(str(tmp_path))
    _rounds(svc, 5)
    snap = svc.stats_snapshot()
    reg, j_reg = obs_metrics.MetricsRegistry(), j_metrics.MetricsRegistry()
    obs_metrics.ingest_snapshot(reg, "bo_service", snap, labels={"pod": 0})
    j_metrics.ingest_snapshot(j_reg, "bo_service", snap, labels={"pod": 0})
    text = reg.render_prometheus()
    j_text = j_reg.render_prometheus().replace(
        "XLA traces by classified cause", "program traces by classified "
        "cause")
    assert text == j_text
    base = {"component": "bo_service", "pod": "0"}
    assert reg.gauge("repro_tenant_served").value(
        labels=dict(base, tenant="a")) == 5
    assert reg.gauge("repro_svc_rung_index").value(labels=base) == 0
    assert reg.gauge("repro_n_mso_rounds").value(
        labels=base) == snap["n_mso_rounds"]
    assert 'repro_tenant_weight{component="bo_service",pod="0",' \
        'tenant="b"} 1' in text


# =============================================================== export
def _traced_service_events(tmp_path):
    tr = obs_trace.enable()
    svc, _ = _journaled_service(str(tmp_path))
    _rounds(svc, 5)
    obs_trace.instant("retrace", program="full", cause="shape")
    return tr.events(), svc


def test_chrome_trace_and_breakdown_match_jax(tmp_path):
    events, _ = _traced_service_events(tmp_path)
    names = {e["name"] for e in events}
    assert {"svc.drr_round", "svc.dispatch", "fleet.ask_batch",
            "fleet.step", "fleet.program.full",
            "fleet.program.mso"} <= names
    meta = {"bench": "test"}
    ct = obs_export.chrome_trace(events, "port", meta)
    assert ct == j_export.chrome_trace(events, "port", meta)
    assert obs_export.validate_chrome_trace(ct) == []
    assert obs_export.phase_breakdown(events) == \
        j_export.phase_breakdown(events)
    bd = obs_export.phase_breakdown(events)
    assert bd["svc.dispatch"]["count"] == 5
    path = str(tmp_path / "trace.json")
    obs_export.write_chrome_trace(path, events, "port", meta)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(ct))


def test_validate_chrome_trace_rejects_malformed():
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0},
        {"ph": "i", "pid": "x", "tid": 1, "ts": 0.0, "args": 3},
        "nope", {"name": "m", "pid": 1, "tid": 0}]}
    errs = obs_export.validate_chrome_trace(bad)
    assert errs == j_export.validate_chrome_trace(bad)
    assert any("dur" in e for e in errs)
    assert any("integer 'pid'" in e for e in errs)
    assert any("not an object" in e for e in errs)
    assert obs_export.validate_chrome_trace([]) == \
        ["top level is list, expected object"]
    evs = [{"name": "a", "ph": "X", "ts": 0, "dur": 1000.0},
           {"name": "a", "ph": "X", "ts": 0, "dur": 3000.0},
           {"name": "c", "ph": "i", "ts": 0}]
    bd = obs_export.phase_breakdown(evs)
    assert set(bd) == {"a"} and bd["a"]["p50_ms"] == 2.0


def test_timeline_from_journal_matches_jax_both_ways(tmp_path):
    """The WAL timeline of a port-written service journal (GP rounds, a
    request left in flight) equals the JAX package's function on the same
    file, and a JAX-written journal gives the same timeline in both."""
    d = str(tmp_path / "port")
    svc, _ = _journaled_service(d)
    _rounds(svc, 5)
    inflight = svc.submit_ask("a", 0)
    assert not inflight.done
    tl = obs_export.timeline_from_journal(d)
    assert tl == j_export.timeline_from_journal(d)
    assert obs_export.validate_chrome_trace(tl) == []
    spans = [e for e in tl["traceEvents"] if e["ph"] == "X"]
    assert len([e for e in spans if e["name"] == "request"]) == 10
    assert len([e for e in spans if e["name"] == "request(inflight)"]) == 1
    tnames = {e["args"]["name"] for e in tl["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"tenant a", "tenant b", "scheduler", "study 0"} <= tnames

    jd = str(tmp_path / "jax")
    clock = VirtualClock()
    jfs = JFleetSampler([JBox.cube(2, 0.0, 1.0)] * 2, seed=0,
                        journal_dir=jd, sleep_fn=clock.sleep,
                        n_startup_trials=4, n_restarts=4, pad_multiple=8,
                        slots=4, posterior_backend="xla", refit_interval=1,
                        warm_start=False, mso_options=JOpts(**_MSO))
    jsvc = JBOService(jfs, [JTenant("a", studies=(0,)),
                            JTenant("b", studies=(1,))], clock=clock)
    _rounds(jsvc, 3)                       # startup asks: no GP program
    jtl = j_export.timeline_from_journal(jd)
    assert obs_export.timeline_from_journal(jd) == jtl
    assert jtl["otherData"]["n_records"] == 2 + 3 * 10


def test_obs_cli_timeline_validate_overhead(tmp_path, capsys):
    d = str(tmp_path / "j")
    svc, _ = _journaled_service(d)
    _rounds(svc, 2)
    out = str(tmp_path / "timeline.json")
    assert obs_main(["timeline", d, "-o", out]) == 0
    assert obs_main(["validate", out]) == 0
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"oops": 1}]}, f)
    assert obs_main(["validate", bad]) == 1
    assert obs_main(["overhead", "--n", "20000"]) == 0
    assert obs_main(["overhead", "--n", "2000", "--budget-ns",
                     "0.0001"]) == 1
    assert not obs_trace.enabled()
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "validate", out], capture_output=True, text=True,
                         env=env, timeout=120)
    assert run.returncode == 0 and "OK" in run.stdout, run.stderr


# ============================================================ NaN guard
def test_guard_leaf_paths_name_fields():
    p = KernelParams(log_lengthscale=torch.zeros(2),
                     log_amplitude=torch.tensor(float("nan")),
                     log_noise=torch.tensor(0.0))
    gp = GPState(x_train=torch.zeros(3, 2), y_train=torch.zeros(3),
                 params=p, chol=torch.eye(3), alpha=torch.zeros(3))
    tree = ((gp, 4, None, torch.arange(3)), {"best": torch.tensor(1.0)})
    paths = [path for path, _ in _leaves(tree)]
    assert paths[:3] == ["[0][0].x_train", "[0][0].y_train",
                         "[0][0].params.log_lengthscale"]
    assert "[1]['best']" in paths
    assert all("[0][3]" not in q for q in paths)     # integer tensor
    tr = obs_trace.enable()
    g = FiniteGuard(lambda *a: a, "full")
    with pytest.raises(NonFiniteError,
                       match=r"'full' at leaf \[0\]\[0\]\.params\."
                             r"log_amplitude"):
        g(gp)
    (ev,) = [e for e in tr.events() if e["name"] == "nan_guard.nonfinite"]
    assert ev["args"] == {"program": "full", "direction": "inputs",
                          "leaf": "[0][0].params.log_amplitude"}
    out = FiniteGuard(lambda x: {"y": x * float("inf")}, "mso")
    with pytest.raises(NonFiniteError, match=r"outputs .*'mso' at leaf "
                                             r"\['y'\]"):
        out(torch.ones(2))


def _ask_run(mode):
    if mode == "trace":
        obs_trace.enable()
    ask = AskEngine(EvalEngine(logei_acq, "cpu"),
                    AskConfig(dim=2, n_restarts=4, pad_bucket=8,
                              refit_interval=3))
    guards = list(install_nan_guard(ask)) if mode == "guard" else []
    rng = np.random.default_rng(0)
    xs = []
    for i in range(5):
        xi = rng.uniform(0, 1, 2)
        ask.observe(xi, _sphere(xi))
        if i >= 1:
            gen = torch.Generator().manual_seed(i)
            bx, _ = ask.suggest(torch.rand((3, 2), generator=gen,
                                           dtype=torch.float64), fit_seed=i)
            xs.append(bx)
    obs_trace.disable()
    return ask, guards, np.array(xs)


def test_nan_guard_on_solo_ask_engine():
    """Both AskEngine programs guarded, idempotently and outermost, or the
    tracer on: the same suggestions, snapshots and compile counts as the
    plain run."""
    plain, _, x_plain = _ask_run("plain")
    traced, _, x_traced = _ask_run("trace")
    np.testing.assert_array_equal(x_traced, x_plain)
    assert traced.stats_snapshot() == plain.stats_snapshot()
    ask, g1, x = _ask_run("guard")
    g2 = list(install_nan_guard(ask))
    assert len(g1) == 2 and all(a is b for a, b in zip(g1, g2))
    assert isinstance(ask._full_prog, FiniteGuard)
    assert isinstance(ask._full_prog._inner, obs_trace.ProgramTimer)
    np.testing.assert_array_equal(x, x_plain)
    assert ask.stats_snapshot() == plain.stats_snapshot()
    st = nan_guard_stats(ask)
    assert st["installed"] and st["n_guard_checks"] == 4
    assert nan_guard_stats(plain) == {"installed": False,
                                      "n_guard_checks": 0}
    assert ask._full_prog.retrace_summary() == \
        plain._full_prog.retrace_summary()


def _fleet_run(mode):
    if mode == "trace":
        obs_trace.enable()
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * 3, seed=0,
                      **_fleet_kw(slots=2, refit_interval=2))
    if mode == "guard":
        install_nan_guard(fs.fleet)
    for _ in range(7):
        for i, t in enumerate(fs.ask_all()):
            fs.tell(i, t.trial_id, _sphere(t.x))
    obs_trace.disable()
    return fs


def test_nan_guard_and_tracer_on_fleet_keep_programs_and_bits():
    """The fleet's three block programs guarded (one check a program
    call), or the tracer on: the same suggestions, snapshot and compile
    counts as the plain run; the guard never trips on idle slots."""
    runs = {m: _fleet_run(m) for m in ("plain", "trace", "guard")}
    base = runs["plain"].stats_snapshot()
    assert base["n_fleet_compiles"] > 0 and base["n_incremental"] > 0
    for mode in ("trace", "guard"):
        fs = runs[mode]
        assert fs.stats_snapshot() == base, mode
        for a, b in zip(runs["plain"].samplers, fs.samplers):
            np.testing.assert_array_equal([t.x for t in a.trials],
                                          [t.x for t in b.trials])
    st = nan_guard_stats(runs["guard"].fleet)
    assert st["installed"]
    assert st["n_guard_checks"] == sum(base["n_block_programs"].values())


def test_nan_guard_trips_on_poisoned_block_naming_program_and_leaf():
    tr = obs_trace.enable()
    fs = FleetSampler([BoxSpace.cube(2, 0.0, 1.0)] * 2, seed=0,
                      **_fleet_kw(slots=2, refit_interval=4))
    install_nan_guard(fs.fleet)
    for _ in range(5):
        for i, t in enumerate(fs.ask_all()):
            fs.tell(i, t.trial_id, _sphere(t.x))
    blk = fs.fleet._blocks[0]
    blk.y[1, 0] = float("nan")             # one slot's observations
    with pytest.raises(NonFiniteError,
                       match=r"inputs of guarded program 'incr' at leaf "
                             r"\[0\]\[1\]"):
        fs.ask_all()
    (ev,) = [e for e in tr.events() if e["name"] == "nan_guard.nonfinite"]
    assert ev["args"]["program"] == "incr"
    assert ev["args"]["leaf"] == "[0][1]"
