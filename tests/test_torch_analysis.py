"""The port's static invariant linter (``repro_torch.analysis``): its two
rules against the reference's on the lint fixtures, baseline and inline
suppression semantics, the CLI's exit codes, and twins of the reference's
WAL-ordering regression tests against the port's fleet and service.

The fixtures (``tests/analysis_fixtures/``) are the reference's; the
linter only parses them, never imports them."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import ALL_RULES as J_ALL_RULES  # noqa: E402
from repro.analysis.core import load_project as j_load_project  # noqa: E402
from repro.analysis.report import run_rules as j_run_rules  # noqa: E402
from repro_torch.analysis import ALL_RULES, RULE_IDS  # noqa: E402
from repro_torch.analysis.baseline import Baseline  # noqa: E402
from repro_torch.analysis.core import load_project  # noqa: E402
from repro_torch.analysis.report import Report, run_rules  # noqa: E402
from repro_torch.bo.sampler import FleetSampler  # noqa: E402
from repro_torch.bo.space import BoxSpace  # noqa: E402
from repro_torch.core.mso import MsoOptions  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "analysis_fixtures"

# the port's rule ids → fixture stems (<stem>_bad.py triggers the rule,
# <stem>_ok.py is clean)
RULE_FIXTURES = {
    "wal-before-state": "wal_before_state",
    "recompile-hazard": "recompile_hazard",
}
FIXTURE_FILES = [FIXTURES / f"{stem}_{kind}.py"
                 for stem in RULE_FIXTURES.values()
                 for kind in ("bad", "ok")]


def _lint(*paths):
    proj = load_project(list(paths), root=REPO, exclude=())
    return run_rules(proj, ALL_RULES)


def _ref_lint(*paths):
    """The reference's findings of the port's rules."""
    proj = j_load_project(list(paths), root=REPO, exclude=())
    rules = [r for r in J_ALL_RULES if r.id in RULE_IDS]
    return j_run_rules(proj, rules)


def _ident(findings):
    return [(f.rule, f.file, f.line, f.func, f.severity, f.snippet)
            for f in findings]


# ========================================================== fixtures
def test_rule_set_is_the_reference_rules_that_apply():
    assert RULE_IDS == ("wal-before-state", "recompile-hazard")
    assert set(RULE_FIXTURES) == set(RULE_IDS)
    for f in FIXTURE_FILES:
        assert f.exists(), f


@pytest.mark.parametrize("path", FIXTURE_FILES, ids=lambda p: p.stem)
def test_findings_equal_the_reference(path):
    """Rule, line, function, severity and snippet of every finding equal
    the reference linter's; a ``_bad`` fixture trips exactly its own rule
    and an ``_ok`` one nothing."""
    got = _lint(path)
    assert _ident(got) == _ident(_ref_lint(path))
    rule = next(r for r, stem in RULE_FIXTURES.items()
                if path.stem.startswith(stem))
    if path.stem.endswith("_bad"):
        assert got and {f.rule for f in got} == {rule}
        for f in got:
            assert f.line > 0 and f.message
    else:
        assert got == []


def test_wal_fixture_finds_all_three_patterns():
    findings = _lint(FIXTURES / "wal_before_state_bad.py")
    assert len(findings) == 3
    assert {f.func.rsplit(".", 1)[-1] for f in findings} == {
        "evict_then_journal", "flag_then_journal", "install_then_journal"}


def test_recompile_fixture_severities():
    """Live-state keying is an error; per-call construction a warning."""
    findings = _lint(FIXTURES / "recompile_hazard_bad.py")
    sev = {f.func.rsplit(".", 1)[-1]: f.severity for f in findings}
    assert sev["ask"] == "error"
    assert sev["rebuild_per_call"] == "warning"


def test_a_wrapped_program_is_still_a_program(tmp_path):
    """The fleet binds ``ProgramTimer(CountingJit(...))``: a live-state
    argument to such a program is flagged as to a bare one."""
    p = tmp_path / "wrapped.py"
    p.write_text(
        "class F:\n"
        "    def __init__(self):\n"
        "        self._prog = ProgramTimer(CountingJit(self._impl), 'p')\n"
        "    def _impl(self, x):\n"
        "        return x\n"
        "    def step(self):\n"
        "        return self._prog(len(self._studies))\n")
    (f,) = _lint(p)
    assert f.rule == "recompile-hazard" and f.func == "F.step"


# ============================================ baseline / suppression
def _one_bad_finding():
    return _lint(FIXTURES / "wal_before_state_bad.py")[0]


def _report(findings, baseline):
    proj = load_project([FIXTURES / "wal_before_state_bad.py"], root=REPO,
                        exclude=())
    return Report(proj, findings, baseline)


def test_baseline_suppresses_with_reason():
    f = _one_bad_finding()
    rep = _report([f], Baseline(entries=[
        Baseline.entry_for(f, "fixture: intentionally bad")]))
    assert not rep.open and len(rep.baselined) == 1 and not rep.failed
    assert rep.baselined[0]["reason"] == "fixture: intentionally bad"


def test_baseline_without_reason_fails():
    f = _one_bad_finding()
    rep = _report([f], Baseline(entries=[Baseline.entry_for(f, "")]))
    assert rep.failed
    assert any(g.rule == "baseline-missing-reason" for g in rep.open)


def test_stale_baseline_entries_surface():
    """An entry whose source line changed or disappeared matches no
    finding and is reported for pruning."""
    bl = Baseline(entries=[
        {"rule": "wal-before-state", "file": "gone.py", "func": "X.y",
         "snippet": "self.q.pop()", "reason": "was real once"}])
    proj = load_project([FIXTURES / "wal_before_state_ok.py"], root=REPO,
                        exclude=())
    rep = Report(proj, [], bl)
    assert len(rep.stale_baseline) == 1
    assert rep.stale_baseline[0]["file"] == "gone.py"
    assert "stale baseline entry" in rep.render()


def test_inline_allow_requires_reason(tmp_path):
    src = (FIXTURES / "wal_before_state_bad.py").read_text()
    p = tmp_path / "allowed.py"
    p.write_text(src.replace(
        "self.studies.pop(st.sid)",
        "self.studies.pop(st.sid)  "
        "# repro: allow[wal-before-state] fixture test"))
    proj = load_project([p], root=REPO, exclude=())
    rep = Report(proj, run_rules(proj, ALL_RULES),
                 Baseline(path=tmp_path / "b.json"))
    assert len(rep.suppressed) == 1       # the allowed line
    assert len(rep.open) == 2             # the other two violations
    assert rep.suppressed[0]["reason"] == "fixture test"
    # a bare allow comment with no reason does NOT suppress
    p2 = tmp_path / "bare.py"
    p2.write_text(src.replace(
        "self.studies.pop(st.sid)",
        "self.studies.pop(st.sid)  # repro: allow[wal-before-state]"))
    proj2 = load_project([p2], root=REPO, exclude=())
    rep2 = Report(proj2, run_rules(proj2, ALL_RULES),
                  Baseline(path=tmp_path / "b2.json"))
    assert len(rep2.open) == 3 and rep2.failed


# ================================================================ CLI
def _run_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_clean_on_tree(tmp_path):
    """The port's tree has no open finding: its one baselined entry is the
    reference's, with the reference's reason, and nothing is stale."""
    out = tmp_path / "report.json"
    res = _run_cli("--check", "--json", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    rep = json.loads(out.read_text())
    assert [(b["rule"], b["func"], b["snippet"]) for b in rep["baselined"]] \
        == [("wal-before-state", "FleetEngine.add_study",
             "self._queue.append(st)")]
    assert rep["stale_baseline"] == []
    ref = json.loads((REPO / "analysis_baseline.json").read_text())
    assert rep["baselined"][0]["reason"] == ref["entries"][0]["reason"]


def test_cli_nonzero_on_the_fixtures(tmp_path):
    out = tmp_path / "report.json"
    res = _run_cli(*[str(p.relative_to(REPO)) for p in FIXTURE_FILES],
                   "--no-baseline", "--check", "--json", str(out))
    assert res.returncode == 1, res.stdout + res.stderr
    rep = json.loads(out.read_text())
    assert {f["rule"] for f in rep["open"]} == set(RULE_IDS)
    assert [(f["rule"], f["file"], f["line"], f["func"], f["severity"])
            for f in rep["open"]] == \
        [i[:5] for i in _ident(_ref_lint(*FIXTURE_FILES))]


# ==================================== WAL ordering regression tests
#
# The reference's linter found five write-ahead violations in its fleet
# engine (_shed, _install, _park, _quarantine_newest, observe's
# migration) and one in its service (_retry).  The port keeps their
# repaired order; each test injects a journal whose append always fails
# and asserts the state transition did NOT happen.

class _ExplodingJournal:
    def append(self, record):
        raise RuntimeError("journal I/O failed")


def _small_fleet(rounds=4):
    sp = BoxSpace.cube(2, 0.0, 1.0)
    fs = FleetSampler([sp] * 2, seed=0, n_startup_trials=3, n_restarts=2,
                      pad_multiple=4, slots=2, posterior_backend="cholesky",
                      refit_interval=2, warm_start=False, device="cpu",
                      mso_options=MsoOptions(maxiter=10, pgtol=1e-1))
    for _ in range(rounds):
        for i, t in enumerate(fs.ask_all()):
            fs.tell(i, t.trial_id, float(np.sum((t.x - 0.3) ** 2)))
    return fs


@pytest.fixture(scope="module")
def driven_fleet():
    return _small_fleet()


def test_wal_shed_not_applied_on_journal_failure(driven_fleet):
    fleet = driven_fleet.fleet
    st = fleet._studies[0]
    fleet.journal = _ExplodingJournal()
    try:
        with pytest.raises(RuntimeError):
            fleet._shed(st, "torn append")
        assert st.shed is None, "shed applied before its WAL record"
    finally:
        fleet.journal = None


def test_wal_park_not_applied_on_journal_failure(driven_fleet):
    fleet = driven_fleet.fleet
    st = fleet._studies[0]
    blk_before, result_before = st.block, st.result
    fleet.journal = _ExplodingJournal()
    try:
        with pytest.raises(RuntimeError):
            fleet._park(st, "torn append")
        assert st.parked is None
        assert st.block is blk_before and st.result is result_before
    finally:
        fleet.journal = None


def test_wal_quarantine_not_applied_on_journal_failure(driven_fleet):
    fleet = driven_fleet.fleet
    st = fleet._studies[1]
    n_before = (len(st.xs), len(st.ys), len(st.tags))
    fleet.journal = _ExplodingJournal()
    try:
        with pytest.raises(RuntimeError):
            fleet._quarantine_newest(st, "torn append")
        assert (len(st.xs), len(st.ys), len(st.tags)) == n_before, \
            "observation dropped before its quarantine WAL record"
    finally:
        fleet.journal = None


def test_wal_migration_not_applied_on_journal_failure():
    fs = _small_fleet(rounds=4)
    fleet = fs.fleet
    st = fleet._studies[0]
    while st.n < 4:                      # fill the pad bucket exactly
        for i, t in enumerate(fs.ask_all()):
            fs.tell(i, t.trial_id, float(np.sum((t.x - 0.3) ** 2)))
    assert st.block is not None and st.n == 4
    fleet.journal = _ExplodingJournal()
    try:
        with pytest.raises(RuntimeError):
            # the 5th observation crosses the pad bucket: migration path
            fleet.observe(0, np.full(2, 0.5), 1.0, tag=99)
        assert st.block is not None, \
            "slot evicted before the migrate WAL record"
        assert st not in fleet._queue
    finally:
        fleet.journal = None


def test_wal_install_not_applied_on_journal_failure(driven_fleet):
    fleet = driven_fleet.fleet
    st = fleet._studies[1]
    blk, slot = st.block, st.slot
    assert blk is not None
    fleet._evict(st)                     # not itself a journaled op
    fleet._queue.remove(st)
    fleet.journal = _ExplodingJournal()
    try:
        with pytest.raises(RuntimeError):
            fleet._install(st, blk, slot)
        assert blk.studies[slot] is None and st.block is None, \
            "slot table updated before the admit WAL record"
    finally:
        fleet.journal = None
        fleet._install(st, blk, slot)    # restore for other tests


def test_wal_service_retry_not_applied_on_journal_failure():
    from repro_torch.serve.bo_service import BOService, TenantConfig

    fs = _small_fleet(rounds=0)
    svc = BOService(fs, [TenantConfig("a", weight=1.0, studies=(0, 1))],
                    max_retries=3, backoff_base=0.01, backoff_cap=0.1)
    req = svc.submit_ask("a", 0)
    req.attempts = 1                     # first transient failure
    state_before, delayed_before = req.state, len(svc._delayed)
    fs.journal = _ExplodingJournal()     # BOService journals via fs
    try:
        with pytest.raises(RuntimeError):
            svc._retry(req, RuntimeError("transient"))
        assert req.state == state_before and req.not_before is None
        assert len(svc._delayed) == delayed_before, \
            "request delayed before its svc_retry WAL record"
    finally:
        fs.journal = None
