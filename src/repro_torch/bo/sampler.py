"""GPSampler-style Bayesian-optimization controller (ask/tell).

Counterpart of ``repro/bo/sampler.py``.  Two suggest pipelines sit behind
``ask()``:

* the **host pipeline** (scipy strategies ``seq``/``cbe``/``dbe``, and
  ``dbe_vec`` with ``fused=False``): from-scratch ``fit_gp``, K⁻¹ for the
  fused posterior, restart points (the incumbent plus B−1 uniform draws),
  ``maximize_acqf``;
* the **fused pipeline** (default for ``dbe_vec``): the
  :class:`~repro_torch.engine.ask.AskEngine`, whose state stays on the
  device, with rank-one GP updates between full MAP refits.

The scipy strategies draw restart points from the same numpy stream as
the reference.  ``dbe_vec`` (both pipelines) draws them from a
``torch.Generator`` seeded from ``(seed, len(trials))`` on the CPU, so the
card and the CPU get the same restarts and an undone ask recomputes the
same point (the reference's ``fold_in(PRNGKey(seed), len(trials))``).

The sampler runs on the card unless the caller asks for the CPU
(``device="cpu"``); without CUDA, the default raises.

:class:`FleetSampler` drives many studies through one
:class:`~repro_torch.engine.fleet.FleetEngine` (``GPSampler.attach_fleet``),
with a write-ahead journal (``bo/journal.py``), checkpoints
(``ckpt/manager.py``), drain and crash recovery.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bo.journal import StudyJournal
from repro_torch.bo.space import BoxSpace
from repro_torch.ckpt.manager import CheckpointManager, \
    install_sigterm_handler
from repro_torch.core.acquisition import logei_acq
from repro_torch.core.lbfgsb import LbfgsbOptions
from repro_torch.core.mso import STRATEGIES, MsoOptions, MsoResult, \
    maximize_acqf
from repro_torch.engine.ask import AskConfig, AskEngine
from repro_torch.engine.cache import merge_retrace_reports
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.fleet import (FleetConfig, FleetEngine,
                                      FleetFullError, FleetStudyError)
from repro_torch.engine.posterior import fused_logei_acq, resolve_backend
from repro_torch.gp.fit import (fit_gp, pad_bucket_for, standardize,
                                standardize_masked, theta_init_grid)
from repro_torch.gp.gpr import with_kinv
from repro_torch.obs import trace as obs


def _standardize_bucketed(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Standardize ``y`` with the moments computed over a pad-bucketed
    masked reduction: bitwise the fused ask's ``standardize_masked``,
    sliced back to the live entries."""
    n = y.shape[0]
    b = pad_bucket_for(n, pad)
    y_pad = torch.zeros((b,), dtype=y.dtype, device=y.device)
    y_pad[:n] = y
    y_std, _, _ = standardize_masked(
        y_pad, torch.arange(b, device=y.device) < n)
    return y_std[:n]


@dataclass
class Trial:
    trial_id: int
    x: np.ndarray
    y: Optional[float] = None
    state: str = "pending"    # pending | complete | failed | quarantined
    ask_time: float = 0.0
    tell_time: float = 0.0
    error: Optional[str] = None      # failure/quarantine reason


@dataclass
class SamplerStats:
    n_gp_fits: int = 0
    fit_time: float = 0.0
    acqf_time: float = 0.0
    acqf_iters: List[float] = field(default_factory=list)
    acqf_rounds: List[int] = field(default_factory=list)
    engine: Optional[dict] = None       # last EvalEngine.stats_snapshot()


class GPSampler:
    """Ask/tell BO over a box space; strategy selects the MSO scheme.

    Two hooks replace the sampler's own random streams, so the parity
    tests can hand in the reference's numbers:

    * ``theta_draws`` maps a fit seed to the (gp_fit_restarts − 1, P)
      U[−1, 1) jitter of that trial's MAP multi-start θ grid (the base θ
      stays the sampler's: the default, or its previous fit under
      ``warm_start``);
    * ``restart_draws`` (``dbe_vec``) maps the trial count to the
      (n_restarts − 1, D) U[0, 1) restart points beside the incumbent.
    """

    def __init__(
        self,
        space: BoxSpace,
        *,
        strategy: str = "dbe",
        n_startup_trials: int = 10,
        n_restarts: int = 10,
        mso_options: Optional[MsoOptions] = None,
        seed: int = 0,
        pad_multiple: int = 32,
        gp_fit_restarts: int = 2,
        posterior_backend: str = "auto",
        fused: Optional[bool] = None,
        refit_interval: int = 8,
        warm_start: bool = True,
        device=None,
        theta_draws: Optional[Callable[[int], np.ndarray]] = None,
        restart_draws: Optional[Callable[[int], np.ndarray]] = None,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        # fused ask(): default for the device-resident strategy; the scipy
        # strategies drive scipy from the host
        self.fused = (strategy == "dbe_vec") if fused is None else bool(fused)
        if self.fused and strategy != "dbe_vec":
            raise ValueError("fused ask() requires strategy='dbe_vec'; "
                             f"got {strategy!r}")
        self.device = resolve_device(device)
        self.space = space
        self.strategy = strategy
        self.n_startup = n_startup_trials
        self.B = n_restarts
        self.mso_options = (mso_options if mso_options is not None
                            else MsoOptions())
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.pad_multiple = pad_multiple
        self.gp_fit_restarts = gp_fit_restarts
        self.refit_interval = refit_interval
        self.warm_start = warm_start
        self.theta_draws = theta_draws
        self.restart_draws = restart_draws
        self.posterior_backend = resolve_backend(posterior_backend,
                                                 self.device)
        # ONE evaluation engine for the whole BO run
        self._acq_fn = (logei_acq if self.posterior_backend == "cholesky"
                        else fused_logei_acq(self.posterior_backend))
        self.engine = EvalEngine(self._acq_fn, device=self.device)
        self._ask: Optional[AskEngine] = None       # fused pipeline state
        self._fleet: Optional[FleetEngine] = None   # attached fleet
        self._fleet_sid = None                      # our study id in it
        self._observed_ids: set = set()             # trials in the ask GP
        # rng draws consumed by startup asks: recovery burns this many to
        # realign the stream before replaying later asks
        self._n_startup_asks = 0
        self.degraded: Optional[str] = None   # left the fleet: why
        self.trials: List[Trial] = []
        self.stats = SamplerStats()
        self.last_mso: Optional[MsoResult] = None
        self.last_acq_state = None       # (GPState, best) of last host ask
        self.last_ask_info = None        # SuggestInfo of last fused ask

    # ----------------------------------------------------------------- api
    def ask(self) -> Trial:
        n_done = sum(t.state == "complete" for t in self.trials)
        if n_done < self.n_startup:
            x = self.space.sample(self.rng, 1)[0]
            self._n_startup_asks += 1
        else:
            x = self._suggest()
        t = Trial(trial_id=len(self.trials), x=x, ask_time=time.time())
        self.trials.append(t)
        return t

    def tell(self, trial_id: int, y: float, *, failed: bool = False,
             error: Optional[str] = None):
        t = self.trials[trial_id]
        if not failed and not np.isfinite(float(y)):
            raise ValueError(
                f"trial {trial_id}: non-finite objective value y={y!r}; "
                f"report evaluation failures with tell(..., failed=True) "
                f"— they never enter GP data")
        t.y = None if failed else float(y)
        t.state = "failed" if failed else "complete"
        t.error = error if failed else None
        t.tell_time = time.time()

    def best(self) -> Trial:
        done = [t for t in self.trials if t.state == "complete"]
        if not done:
            failed = [t for t in self.trials if t.state == "failed"]
            msg = (f"no completed trials to report a best from "
                   f"({len(self.trials)} trials: {len(failed)} failed, "
                   f"{len(self.trials) - len(failed)} pending)")
            errors = [t.error for t in failed if t.error]
            if errors:
                msg += f"; last failure: {errors[-1]}"
            raise RuntimeError(msg)
        return min(done, key=lambda t: t.y)

    def optimize(self, objective, n_trials: int):
        for _ in range(n_trials):
            t = self.ask()
            try:
                self.tell(t.trial_id, objective(t.x))
            except Exception as e:          # noqa: BLE001 — trial isolation
                self.tell(t.trial_id, 0.0, failed=True,
                          error=f"{type(e).__name__}: {e}")
        return self.best()

    # -------------------------------------------------------- inner engine
    def _observations(self):
        done = [t for t in self.trials if t.state == "complete"]
        X = np.stack([t.x for t in done])
        y = np.array([t.y for t in done])
        return X, y

    def _restart_draws(self) -> torch.Tensor:
        """(B−1, D) U[0, 1) restart points of this trial (``dbe_vec``),
        drawn on the CPU from a generator seeded by (seed, len(trials))."""
        n = len(self.trials)
        if self.restart_draws is not None:
            return torch.tensor(np.asarray(self.restart_draws(n),
                                           np.float64))
        key = np.random.SeedSequence([self.seed, n]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device="cpu").manual_seed(int(key))
        return torch.rand((self.B - 1, self.space.dim), generator=gen,
                          dtype=torch.float64)

    def _theta_draws(self, fit_seed: int) -> Optional[np.ndarray]:
        return None if self.theta_draws is None else \
            np.array(self.theta_draws(fit_seed), np.float64)

    def _suggest(self) -> np.ndarray:
        if self.fused:
            return self._suggest_fused()
        X, y = self._observations()
        U = self.space.to_unit(X)
        dev = self.device
        fit_seed = self.seed + len(self.trials)
        # minimize y == maximize -y (standardized)
        t0 = time.perf_counter()
        with obs.span("ask.phase.standardize", n=len(y)):
            y_neg = torch.as_tensor(-y).to(dev)
            if self.strategy == "dbe_vec":
                # the fused program's padded masked reduction: reduction
                # shape changes the last-ulp rounding, and the MAP fit
                # amplifies a 1-ulp y_std difference
                y_std = _standardize_bucketed(y_neg, self.pad_multiple)
            else:
                y_std, _, _ = standardize(y_neg)
        with obs.span("ask.phase.refit", n=len(y)):
            thetas = theta_init_grid(self.space.dim, torch.float64,
                                     self.gp_fit_restarts, fit_seed,
                                     draws=self._theta_draws(fit_seed))
            gp = fit_gp(torch.as_tensor(U).to(dev), y_std,
                        n_restarts=self.gp_fit_restarts,
                        pad_bucket=self.pad_multiple, thetas=thetas)
            if self.posterior_backend == "fused":
                gp = with_kinv(gp)  # fused quadratic-form posterior input
        self.stats.n_gp_fits += 1
        self.stats.fit_time += time.perf_counter() - t0
        best_val = y_std.max()
        self.last_acq_state = (gp, best_val)

        # restart points: incumbent + (B-1) uniform (GPSampler-style)
        with obs.span("ask.phase.restart_sampling", B=self.B):
            inc = U[int(np.argmin(y))]
            if self.strategy == "dbe_vec":
                rand = self._restart_draws().numpy()
            else:
                rand = self.rng.uniform(0.0, 1.0,
                                        (self.B - 1, self.space.dim))
            x0 = np.concatenate([inc[None], rand], 0)

        t0 = time.perf_counter()
        with obs.span("ask.phase.mso", strategy=self.strategy):
            res = maximize_acqf(self._acq_fn, x0, 0.0, 1.0,
                                acq_state=(gp, best_val),
                                strategy=self.strategy,
                                options=self.mso_options,
                                engine=self.engine)
        self.stats.acqf_time += time.perf_counter() - t0
        self.stats.acqf_iters.append(float(np.median(res.n_iters)))
        self.stats.acqf_rounds.append(res.n_rounds)
        self.stats.engine = res.engine_stats
        self.last_mso = res
        return self.space.from_unit(np.clip(res.best_x, 0.0, 1.0))

    # ------------------------------------------------------- fused path
    def _suggest_fused(self) -> np.ndarray:
        if self._fleet is not None:
            return self._suggest_fleet()
        done = [t for t in self.trials if t.state == "complete"]
        if self._ask is None:
            o = self.mso_options
            self._ask = AskEngine(self.engine, AskConfig(
                dim=self.space.dim, n_restarts=self.B,
                backend=self.posterior_backend,
                pad_bucket=self.pad_multiple,
                refit_interval=self.refit_interval,
                warm_start=self.warm_start,
                gp_fit_restarts=self.gp_fit_restarts,
                mso=LbfgsbOptions(m=o.m, maxiter=o.maxiter, pgtol=o.pgtol,
                                  ftol=o.ftol, maxls=o.maxls)))
        ask = self._ask
        # lazy observation sync, keyed by trial id, not list position:
        # out-of-order tells must not duplicate or drop observations
        for t in done:
            if t.trial_id not in self._observed_ids:
                ask.observe(self.space.to_unit(t.x), t.y)
                self._observed_ids.add(t.trial_id)

        fit_seed = self.seed + len(self.trials)
        t0 = time.perf_counter()
        best_x, info = ask.suggest(self._restart_draws(), fit_seed,
                                   theta_draws=self._theta_draws(fit_seed))
        wall = time.perf_counter() - t0
        eng, ak = self.engine.stats_snapshot(), ask.stats_snapshot()
        return self._record_fused_suggest(
            best_x, info, wall,
            {**eng, **ak,
             "retraces": merge_retrace_reports(eng["retraces"],
                                               ak["retraces"])})

    def _record_fused_suggest(self, best_x, info, wall, snapshot):
        """Stats tail of the fused suggest path.  Per-restart state stays
        on the device; only the suggestion and scalar diagnostics reach
        the host."""
        if info.kind != "incremental":
            self.stats.n_gp_fits += 1
        self.stats.fit_time += info.fit_ms / 1e3
        self.stats.acqf_time += wall - info.fit_ms / 1e3
        self.stats.acqf_iters.append(float(np.median(info.n_iters.cpu())))
        self.stats.acqf_rounds.append(int(info.rounds))
        self.stats.engine = snapshot
        self.last_mso = None
        self.last_ask_info = info
        return self.space.from_unit(np.clip(best_x, 0.0, 1.0))

    # ------------------------------------------------------- fleet path
    def attach_fleet(self, fleet: FleetEngine, study_id=None) -> "GPSampler":
        """Route this sampler's fused ask() through a shared
        :class:`~repro_torch.engine.fleet.FleetEngine` (one set of
        programs serves every attached study).

        Must be called before the first trial; the fleet's static config
        and device must match this sampler's, or the stacked programs
        would not reproduce the solo pipeline.  Returns ``self``.
        """
        if not self.fused:
            raise ValueError("attach_fleet() requires the fused dbe_vec "
                             "pipeline (strategy='dbe_vec', fused=True)")
        if self.trials or self._ask is not None:
            raise ValueError("attach_fleet() must be called before the "
                             "first trial")
        cfg = fleet.cfg
        o = self.mso_options
        mine = dict(dim=self.space.dim, n_restarts=self.B,
                    pad_bucket=self.pad_multiple,
                    backend=self.posterior_backend,
                    refit_interval=self.refit_interval,
                    warm_start=self.warm_start,
                    gp_fit_restarts=self.gp_fit_restarts,
                    mso=(o.m, o.maxiter, o.pgtol, o.ftol, o.maxls),
                    device=self.device)
        theirs = {k: getattr(cfg, k) for k in mine
                  if k not in ("mso", "device")}
        theirs["mso"] = (cfg.mso.m, cfg.mso.maxiter, cfg.mso.pgtol,
                         cfg.mso.ftol, cfg.mso.maxls)
        theirs["device"] = fleet.device
        if mine != theirs:
            raise ValueError(f"fleet config mismatch: sampler has {mine}, "
                             f"fleet has {theirs}")
        sid = study_id if study_id is not None else f"study-{id(self):x}"
        fleet.add_study(sid)
        self._fleet, self._fleet_sid = fleet, sid
        return self

    def _sync_fleet_observations(self) -> None:
        for t in self.trials:
            if t.state == "complete" and t.trial_id not in self._observed_ids:
                # tag=trial_id: a later quarantine names the trial
                self._fleet.observe(self._fleet_sid,
                                    self.space.to_unit(t.x), t.y,
                                    tag=t.trial_id)
                self._observed_ids.add(t.trial_id)

    def _detach_fleet(self, reason: str) -> None:
        """Leave the fleet (shed, parked or rejected) and go on with the
        solo fused :class:`AskEngine`; a fresh ``_observed_ids`` makes the
        next suggest sync every clean observation into it."""
        self._fleet, self._fleet_sid = None, None
        self._observed_ids = set()
        self.degraded = reason

    def mark_quarantined(self, trial_id: int, reason: str) -> None:
        """The fleet quarantined this trial's observation out of GP data;
        the trial keeps its y for audit but no longer counts as
        complete."""
        t = self.trials[trial_id]
        t.state = "quarantined"
        t.error = reason

    def _fleet_request(self) -> Tuple[torch.Tensor, int, Optional[np.ndarray]]:
        """This trial's (restart draws, fit seed, θ-grid draws): the solo
        pipeline's streams, so a study gets the same numbers in a fleet."""
        fit_seed = self.seed + len(self.trials)
        return self._restart_draws(), fit_seed, self._theta_draws(fit_seed)

    def prefetch_suggest(self) -> bool:
        """Enqueue this sampler's next suggest into the attached fleet
        without running it: the caller batches many studies' requests
        into one ``fleet.step()`` and then calls ``ask()`` to collect.
        False while the sampler is in random startup, or after it left the
        fleet."""
        if self._fleet is None:
            raise ValueError("no fleet attached")
        n_done = sum(t.state == "complete" for t in self.trials)
        if n_done < self.n_startup:
            return False
        self._sync_fleet_observations()
        try:
            self._fleet.request_suggest(self._fleet_sid,
                                        *self._fleet_request())
        except FleetStudyError as e:
            # shed or parked meanwhile: the next ask() runs solo
            self._detach_fleet(str(e))
            return False
        return True

    def _suggest_fleet(self) -> np.ndarray:
        self._sync_fleet_observations()
        t0 = time.perf_counter()
        try:
            res = self._fleet.pop_result(self._fleet_sid)
            if res is None:   # solo path: request + step + collect now
                res = self._fleet.suggest(self._fleet_sid,
                                          *self._fleet_request())
        except FleetStudyError as e:
            res = e
        if isinstance(res, FleetStudyError):
            # the fleet shed or parked this study: degrade to the solo
            # engine rather than failing the caller's ask()
            self._detach_fleet(str(res))
            return self._suggest_fused()
        best_x, info = res
        wall = time.perf_counter() - t0
        eng = self._fleet.engine.stats_snapshot()
        flt = self._fleet.stats_snapshot()
        return self._record_fused_suggest(
            best_x, info, wall,
            {**eng, **flt,
             "retraces": merge_retrace_reports(eng["retraces"],
                                               flt["retraces"])})

    # ------------------------------------------------- journal (restart)
    def save(self, path: str):
        """The trial history as JSON (the reference's format), written
        atomically."""
        rec = {
            "seed": self.seed,
            "strategy": self.strategy,
            "lower": self.space.lower.tolist(),
            "upper": self.space.upper.tolist(),
            "trials": [
                dict(trial_id=t.trial_id, x=t.x.tolist(), y=t.y,
                     state=t.state, error=t.error) for t in self.trials
            ],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)        # atomic

    @classmethod
    def load(cls, path: str, **kwargs) -> "GPSampler":
        """A sampler with the trials of a :meth:`save` file; a trial that
        never came back (crash, preemption) is marked failed.  ``kwargs``
        go to the constructor (``device="cpu"`` on the CPU)."""
        with open(path) as f:
            rec = json.load(f)
        space = BoxSpace(np.array(rec["lower"]), np.array(rec["upper"]))
        s = cls(space, strategy=rec["strategy"], seed=rec["seed"], **kwargs)
        for tr in rec["trials"]:
            t = Trial(trial_id=tr["trial_id"], x=np.array(tr["x"]),
                      y=tr["y"], state=tr["state"], error=tr.get("error"))
            if t.state == "pending":
                t.state = "failed"
                t.error = "trial never completed (crash/preemption)"
            s.trials.append(t)
        return s


_TRIAL_STATE = {"pending": 0, "complete": 1, "failed": 2, "quarantined": 3}
_TRIAL_STATE_INV = {v: k for k, v in _TRIAL_STATE.items()}
# the reference's posterior backends, as a journal it wrote names them
_JAX_BACKENDS = {"xla": "cholesky", "pallas": "fused",
                 "pallas_interpret": "fused"}
_REF_BACKENDS = {"cholesky": "xla", "fused": "pallas"}


@dataclass
class RecoveryReport:
    """What :meth:`FleetSampler.recover` reconstructed, and from where."""
    snapshot_step: Optional[int]     # checkpoint the replay started from
    n_records: int                   # intact journal records in total
    n_replayed: int                  # records replayed past the snapshot
    truncated_bytes: int             # torn journal tail dropped at open
    pending: List[Tuple[int, int]]   # (study, trial_id) asked, never told
    replay_ms: float


class FleetSampler:
    """Drive S concurrent BO studies through ONE fleet ask plane.

    One :class:`~repro_torch.engine.fleet.FleetEngine` (and one
    :class:`EvalEngine`) serves every study: each round all studies'
    requests are enqueued (``prefetch_suggest``), ONE ``fleet.step()``
    runs the stacked programs, and each study's :class:`GPSampler`
    collects its suggestion.  Study i is a solo sampler with seed
    ``seed + i``: the same restart and θ-grid streams, so at a pinned
    ``slots`` width its trajectory is bitwise the same whichever slot and
    company it has, and within 1e-10 of the solo fused sampler.

    ``spaces`` is one :class:`BoxSpace` (replicated ``n_studies`` times)
    or a list; every study shares the static fleet config.  ``device``
    follows the entry-point rule (``None``: the card).

    ``journal_dir`` turns on the durability plane: every ask and tell is
    written (fsync'd, checksummed) to a
    :class:`~repro_torch.bo.journal.StudyJournal` before it takes effect,
    :meth:`checkpoint` snapshots bound how much of it :meth:`recover`
    replays, and the on-disk formats are the reference's.
    ``max_studies`` / ``max_queue`` / ``max_blocks`` /
    ``admission_timeout`` bound admission; with ``degrade_to_solo=True``
    a rejected, shed or parked study goes on solo instead of erroring.
    ``fault_injector`` hooks the journal and the refit health flags.
    ``theta_draws`` (fit seed → (R−1, P)) and ``restart_draws`` ((study
    seed, trial count) → (B−1, D)) replace the studies' random streams,
    as ``GPSampler``'s hooks do.  ``mesh`` (several cards) is not ported.
    """

    def __init__(
        self,
        spaces,
        *,
        n_studies: Optional[int] = None,
        seed: int = 0,
        slots: int = 8,
        strategy: str = "dbe_vec",
        n_startup_trials: int = 10,
        n_restarts: int = 10,
        mso_options: Optional[MsoOptions] = None,
        pad_multiple: int = 32,
        gp_fit_restarts: int = 2,
        posterior_backend: str = "auto",
        refit_interval: int = 8,
        warm_start: bool = True,
        mesh=None,
        journal_dir: Optional[str] = None,
        fault_injector=None,
        max_studies: Optional[int] = None,
        max_queue: Optional[int] = None,
        max_blocks: Optional[int] = None,
        admission_timeout: Optional[float] = None,
        quarantine_retries: int = 2,
        retry_backoff_base: float = 0.0,
        retry_backoff_cap: float = 2.0,
        retry_backoff_jitter: float = 0.25,
        degrade_to_solo: bool = False,
        sleep_fn=None,
        device=None,
        theta_draws: Optional[Callable[[int], np.ndarray]] = None,
        restart_draws: Optional[Callable[[int, int], np.ndarray]] = None,
        _journal: Optional[StudyJournal] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a fleet across several cards (mesh=) is not ported yet: "
                "ROADMAP queue A item 9b")
        if strategy != "dbe_vec":
            raise ValueError("FleetSampler requires strategy='dbe_vec'")
        if isinstance(spaces, BoxSpace):
            spaces = [spaces] * int(n_studies if n_studies else 1)
        dims = {sp.dim for sp in spaces}
        if len(dims) != 1:
            raise ValueError(f"all studies must share one dim, got {dims}")
        dev = resolve_device(device)
        backend = resolve_backend(posterior_backend, dev)
        o = mso_options if mso_options is not None else MsoOptions()
        # ------------------------------------------------ durability plane
        self.fault_injector = fault_injector
        self._preempt = None
        if _journal is not None:         # recover(): reuse the open journal
            self.journal: Optional[StudyJournal] = _journal
            journal_dir = _journal.dir
        elif journal_dir is not None:
            self.journal = StudyJournal(journal_dir,
                                        fault_injector=fault_injector)
        else:
            self.journal = None
        self.ckpt = (CheckpointManager(os.path.join(journal_dir, "ckpt"))
                     if journal_dir is not None else None)
        if self.journal is not None and self.journal.seq == 0:
            # record 0 pins everything recover() needs to rebuild the
            # fleet in an empty process (the reference's keys, and its
            # backend names, so that its recover() reads this journal)
            self.journal.append({
                "op": "config",
                "lower": [sp.lower.tolist() for sp in spaces],
                "upper": [sp.upper.tolist() for sp in spaces],
                "seed": seed, "slots": slots,
                "n_startup_trials": n_startup_trials,
                "n_restarts": n_restarts, "pad_multiple": pad_multiple,
                "gp_fit_restarts": gp_fit_restarts,
                "posterior_backend": _REF_BACKENDS[backend],
                "refit_interval": refit_interval,
                "warm_start": warm_start, "max_studies": max_studies,
                "max_queue": max_queue, "max_blocks": max_blocks,
                "admission_timeout": admission_timeout,
                "quarantine_retries": quarantine_retries,
                "retry_backoff_base": retry_backoff_base,
                "retry_backoff_cap": retry_backoff_cap,
                "retry_backoff_jitter": retry_backoff_jitter,
                "degrade_to_solo": degrade_to_solo,
                "mso": dict(m=o.m, maxiter=o.maxiter, pgtol=o.pgtol,
                            ftol=o.ftol, maxls=o.maxls,
                            bucketed=o.bucketed)})
        # ------------------------------------------------------ ask plane
        acq = logei_acq if backend == "cholesky" else fused_logei_acq(backend)
        self.engine = EvalEngine(acq, device=dev)
        self.fleet = FleetEngine(self.engine, FleetConfig(
            dim=dims.pop(), n_restarts=n_restarts, slots=slots,
            backend=backend, pad_bucket=pad_multiple,
            refit_interval=refit_interval, warm_start=warm_start,
            gp_fit_restarts=gp_fit_restarts,
            mso=LbfgsbOptions(m=o.m, maxiter=o.maxiter, pgtol=o.pgtol,
                              ftol=o.ftol, maxls=o.maxls),
            max_studies=max_studies, max_queue=max_queue,
            max_blocks=max_blocks, admission_timeout=admission_timeout,
            quarantine_retries=quarantine_retries,
            retry_backoff_base=retry_backoff_base,
            retry_backoff_cap=retry_backoff_cap,
            retry_backoff_jitter=retry_backoff_jitter),
            journal=self.journal, fault_injector=fault_injector,
            sleep_fn=sleep_fn)
        self.fleet.on_quarantine = self._on_quarantine
        self.samplers: List[GPSampler] = []
        for i, sp in enumerate(spaces):
            rd = None
            if restart_draws is not None:
                rd = (lambda n, sd=seed + i: restart_draws(sd, n))
            s = GPSampler(sp, strategy="dbe_vec", fused=True, seed=seed + i,
                          n_startup_trials=n_startup_trials,
                          n_restarts=n_restarts, mso_options=replace(o),
                          pad_multiple=pad_multiple,
                          gp_fit_restarts=gp_fit_restarts,
                          posterior_backend=backend,
                          refit_interval=refit_interval,
                          warm_start=warm_start, device=dev,
                          theta_draws=theta_draws, restart_draws=rd)
            try:
                s.attach_fleet(self.fleet, study_id=i)
            except FleetFullError as e:
                if not degrade_to_solo:
                    raise
                s.degraded = str(e)       # solo from birth (load shed)
            self.samplers.append(s)

    def __len__(self) -> int:
        return len(self.samplers)

    def _append(self, rec: dict) -> None:
        if self.journal is not None:
            self.journal.append(rec)

    def _on_quarantine(self, sid, tag, reason) -> None:
        if tag is not None:
            self.samplers[sid].mark_quarantined(tag, reason)

    def ask_all(self) -> List[Trial]:
        """One fleet trial boundary: enqueue every study's suggest, run
        ONE batched step, collect per-study trials (startup studies
        sample randomly, degraded ones run solo).  Every ask is journaled
        before the trial is handed back."""
        out = self.ask_batch(range(len(self.samplers)))
        for t in out:                    # sync semantics: failures raise
            if isinstance(t, Exception):
                raise t
        return out

    def ask_batch(self, studies) -> List:
        """Ask a subset of studies at one trial boundary, batched into ONE
        ``fleet.step()``.  A study's failure is isolated: its position in
        the returned list holds the exception instead."""
        studies = list(studies)
        tr = obs.get()
        t0 = tr.now_us() if tr is not None else 0.0
        for i in studies:
            s = self.samplers[i]
            if s._fleet is not None:
                s.prefetch_suggest()
        self.fleet.step()
        out: List = []
        for i in studies:
            s = self.samplers[i]
            n_done = sum(t.state == "complete" for t in s.trials)
            startup = n_done < s.n_startup
            try:
                t = s.ask()
            except Exception as e:       # noqa: BLE001 — study isolation
                out.append(e)
                continue
            self._append({"op": "ask", "study": i, "trial": t.trial_id,
                          "x": t.x.tolist(), "startup": startup})
            out.append(t)
        if tr is not None:
            tr.record_span("fleet.ask_batch", t0, tr.now_us() - t0,
                           n=len(studies))
        return out

    def cancel_ask(self, study: int) -> bool:
        """Withdraw a study's in-flight fleet suggest; a later request
        recomputes the same point (the draws follow the trial count)."""
        s = self.samplers[study]
        if s._fleet is None:
            return False
        return self.fleet.cancel_request(s._fleet_sid)

    def tell(self, study: int, trial_id: int, y: float, *,
             failed: bool = False, error: Optional[str] = None) -> None:
        if not failed and not np.isfinite(float(y)):
            # validate BEFORE journaling: a poison value must never be
            # acknowledged into the journal
            raise ValueError(
                f"study {study} trial {trial_id}: non-finite objective "
                f"value y={y!r}; report evaluation failures with "
                f"failed=True — they never enter GP data")
        self._append({"op": "tell", "study": study, "trial": trial_id,
                      "y": None if failed else float(y), "failed": failed,
                      "error": error})
        self.samplers[study].tell(trial_id, y, failed=failed, error=error)
        fi = self.fault_injector
        if fi is not None and hasattr(fi, "tell_delay"):
            d = fi.tell_delay()     # injected slow tell (virtual clock)
            if d > 0.0:
                self.fleet._sleep(d)

    def optimize(self, objectives, n_rounds: int) -> List[Trial]:
        """``n_rounds`` synchronized ask/tell rounds; ``objectives`` is one
        callable or one per study.  Returns each study's best trial.  If
        :meth:`install_drain_handler` armed a preemption flag, a SIGTERM
        finishes the round in flight, then drains and stops."""
        if callable(objectives):
            objectives = [objectives] * len(self.samplers)
        for _ in range(n_rounds):
            if self._preempt is not None and self._preempt.triggered:
                self.drain()
                break
            trials = self.ask_all()
            for s, t in enumerate(trials):
                try:
                    y = objectives[s](t.x)
                except Exception as e:   # noqa: BLE001 — trial isolation
                    self.tell(s, t.trial_id, 0.0, failed=True,
                              error=f"{type(e).__name__}: {e}")
                    continue
                if np.isfinite(float(y)):
                    self.tell(s, t.trial_id, y)
                else:                    # degrade, don't crash the loop
                    self.tell(s, t.trial_id, 0.0, failed=True,
                              error=f"non-finite objective value {y!r}")
        return [s.best() for s in self.samplers]

    # ------------------------------------------------- durability plane
    def checkpoint(self) -> int:
        """Snapshot every study's trial history (and warm-start θ): bounds
        how much journal :meth:`recover` replays.  Returns the snapshot
        step, the journal seq watermark (records with ``seq >=`` it come
        after the snapshot)."""
        if self.ckpt is None:
            raise ValueError("checkpoint() needs journal_dir")
        step = self.journal.seq
        flat: Dict[str, np.ndarray] = {
            "seq": np.asarray(step, np.int64),
            "n_studies": np.asarray(len(self.samplers), np.int64),
        }
        for i, s in enumerate(self.samplers):
            flat[f"s{i}/x"] = (np.stack([t.x for t in s.trials])
                               if s.trials else np.zeros((0, s.space.dim)))
            flat[f"s{i}/y"] = np.asarray(
                [np.nan if t.y is None else t.y for t in s.trials],
                np.float64)
            flat[f"s{i}/state"] = np.asarray(
                [_TRIAL_STATE[t.state] for t in s.trials], np.int64)
            flat[f"s{i}/error_json"] = np.asarray(
                json.dumps([t.error for t in s.trials]))
            flat[f"s{i}/n_startup_asks"] = np.asarray(
                s._n_startup_asks, np.int64)
            if s._fleet is not None:
                th = self.fleet.study_theta(s._fleet_sid)
                if th is not None:
                    flat[f"s{i}/theta"] = th
        self.ckpt.save_flat(step, flat)
        self._append({"op": "snapshot", "step": step})
        obs.instant("fleet.checkpoint", step=step)
        return step

    def install_drain_handler(self):
        """Arm SIGTERM/SIGUSR1; returns the flag that :meth:`optimize`
        polls at round boundaries (other drivers poll ``triggered`` and
        call :meth:`drain`)."""
        self._preempt = install_sigterm_handler()
        return self._preempt

    def drain(self) -> dict:
        """Graceful shutdown: serve the suggests already enqueued,
        checkpoint, journal a drain record, close the journal.  The
        journal directory is then a complete, recoverable image."""
        with obs.span("fleet.drain"):
            served = self.fleet.step()
            step = None
            if self.ckpt is not None:
                step = self.checkpoint()
            if self.journal is not None:
                self._append({"op": "drain", "served": served,
                              "snapshot": step})
                self.journal.close()
        return {"served": served, "snapshot_step": step}

    @classmethod
    def recover(cls, journal_dir: str, *, device=None, mesh=None,
                fault_injector=None, sleep_fn=None
                ) -> Tuple["FleetSampler", RecoveryReport]:
        """Rebuild a crashed or drained fleet from its journal directory.

        The config record rebuilds the fleet; the newest valid snapshot
        restores the trials (burning one rng draw per recorded startup
        ask so the random streams realign); the journal past the snapshot
        replays through the normal paths (tells re-enter through the
        observation sync, studies re-admit through the scheduler, and the
        first full refit rebuilds the factors, as after a migration), so
        recovery adds no program.  Trials asked but never told stay
        pending and are listed in the report.  A journal the reference
        wrote recovers here too (its backend names map to the port's)."""
        t0 = time.perf_counter()
        tr_obs = obs.get()
        t_obs = tr_obs.now_us() if tr_obs is not None else 0.0
        journal = StudyJournal(journal_dir, fault_injector=fault_injector)
        records = journal.replay()
        if not records or records[0].get("op") != "config":
            journal.close()
            raise ValueError(f"journal at {journal_dir!r} has no config "
                             f"record — nothing to recover")
        cfg = dict(records[0])
        cfg["posterior_backend"] = _JAX_BACKENDS.get(
            cfg["posterior_backend"], cfg["posterior_backend"])
        spaces = [BoxSpace(np.asarray(lo), np.asarray(up))
                  for lo, up in zip(cfg["lower"], cfg["upper"])]
        defaults = {"retry_backoff_base": 0.0, "retry_backoff_cap": 2.0,
                    "retry_backoff_jitter": 0.25}
        fs = cls(spaces, mesh=mesh, device=device,
                 fault_injector=fault_injector, sleep_fn=sleep_fn,
                 _journal=journal, mso_options=MsoOptions(**cfg["mso"]),
                 **{k: cfg.get(k, defaults.get(k)) for k in (
                     "seed", "slots", "n_startup_trials", "n_restarts",
                     "pad_multiple", "gp_fit_restarts",
                     "posterior_backend", "refit_interval", "warm_start",
                     "max_studies", "max_queue", "max_blocks",
                     "admission_timeout", "quarantine_retries",
                     "retry_backoff_base", "retry_backoff_cap",
                     "retry_backoff_jitter", "degrade_to_solo")})
        # ---- snapshot: bulk state, bounding the replay
        snap_seq, snap_step = 0, None
        if fs.ckpt is not None:
            snap_step = fs.ckpt.latest_step()
        if snap_step is not None:
            flat = fs.ckpt.load_flat(snap_step)
            snap_seq = int(flat["seq"])
            for i, s in enumerate(fs.samplers):
                errors = json.loads(str(flat[f"s{i}/error_json"]))
                xs, ys = flat[f"s{i}/x"], flat[f"s{i}/y"]
                for j, code in enumerate(flat[f"s{i}/state"]):
                    y = float(ys[j])
                    s.trials.append(Trial(
                        trial_id=j, x=np.asarray(xs[j]),
                        y=None if np.isnan(y) else y,
                        state=_TRIAL_STATE_INV[int(code)], error=errors[j]))
                n_startup = int(flat[f"s{i}/n_startup_asks"])
                for _ in range(n_startup):
                    s.space.sample(s.rng, 1)      # realign the stream
                s._n_startup_asks = n_startup
                if f"s{i}/theta" in flat and s._fleet is not None:
                    fs.fleet.restore_theta(s._fleet_sid,
                                           flat[f"s{i}/theta"])
        # ---- replay the journal tail through the normal paths
        n_replayed = 0
        for rec in records:
            if rec["seq"] < snap_seq:
                continue
            n_replayed += 1
            op = rec["op"]
            if op == "ask":
                s = fs.samplers[rec["study"]]
                if rec["trial"] != len(s.trials):
                    raise ValueError(
                        f"journal gap: study {rec['study']} ask for trial "
                        f"{rec['trial']} but only {len(s.trials)} known")
                if rec["startup"]:
                    s.space.sample(s.rng, 1)      # burn: realign stream
                    s._n_startup_asks += 1
                s.trials.append(Trial(trial_id=rec["trial"],
                                      x=np.asarray(rec["x"])))
            elif op == "tell":
                s = fs.samplers[rec["study"]]
                s.tell(rec["trial"], 0.0 if rec["failed"] else rec["y"],
                       failed=rec["failed"], error=rec.get("error"))
            elif op == "refit":
                s = fs.samplers[rec["sid"]]
                if s._fleet is not None:
                    fs.fleet.restore_theta(s._fleet_sid,
                                           np.asarray(rec["theta"]))
            elif op == "quarantine":
                s = fs.samplers[rec["sid"]]
                if rec.get("trial") is not None:
                    s.mark_quarantined(rec["trial"], rec["reason"])
            elif op in ("shed", "park"):
                s = fs.samplers[rec["sid"]]
                if s._fleet is not None:
                    fs.fleet.shed_study(s._fleet_sid, rec["reason"])
                    s._detach_fleet(rec["reason"])
            # config/snapshot/admit/migrate/reject/backoff/drain: records
        pending = [(i, t.trial_id) for i, s in enumerate(fs.samplers)
                   for t in s.trials if t.state == "pending"]
        report = RecoveryReport(
            snapshot_step=snap_step, n_records=len(records),
            n_replayed=n_replayed, truncated_bytes=journal.truncated_bytes,
            pending=pending, replay_ms=1e3 * (time.perf_counter() - t0))
        if tr_obs is not None:
            tr_obs.record_span("fleet.recover", t_obs,
                               tr_obs.now_us() - t_obs,
                               n_records=len(records),
                               n_replayed=n_replayed)
        return fs, report

    def stats_snapshot(self) -> dict:
        eng, flt = self.engine.stats_snapshot(), self.fleet.stats_snapshot()
        snap = {**eng, **flt}
        snap["retraces"] = merge_retrace_reports(eng["retraces"],
                                                 flt["retraces"])
        snap["n_degraded"] = sum(s.degraded is not None
                                 for s in self.samplers)
        if self.journal is not None:
            snap["journal_seq"] = self.journal.seq
        return snap
