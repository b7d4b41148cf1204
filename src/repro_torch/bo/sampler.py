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
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bo.space import BoxSpace
from repro_torch.core.acquisition import logei_acq
from repro_torch.core.lbfgsb import LbfgsbOptions
from repro_torch.core.mso import STRATEGIES, MsoOptions, MsoResult, \
    maximize_acqf
from repro_torch.engine.ask import AskConfig, AskEngine
from repro_torch.engine.cache import merge_retrace_reports
from repro_torch.engine.engine import EvalEngine
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
    state: str = "pending"    # pending | complete | failed
    ask_time: float = 0.0
    tell_time: float = 0.0
    error: Optional[str] = None      # failure reason


@dataclass
class SamplerStats:
    n_gp_fits: int = 0
    fit_time: float = 0.0
    acqf_time: float = 0.0
    acqf_iters: List[float] = field(default_factory=list)
    acqf_rounds: List[int] = field(default_factory=list)
    engine: Optional[dict] = None       # last EvalEngine.stats_snapshot()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


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
        self._observed_ids: set = set()             # trials in the ask GP
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

    def attach_fleet(self, fleet, study_id=None):
        raise _not_ported("attach_fleet()", "queue A item 9")

    def save(self, path: str):
        raise _not_ported("save()", "queue A item 7 (journal)")

    @classmethod
    def load(cls, path: str, **kwargs):
        raise _not_ported("load()", "queue A item 7 (journal)")

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


class FleetSampler:
    """Many studies behind one fleet: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("FleetSampler", "queue A item 9")
