"""GPSampler-style Bayesian-optimization controller (ask/tell).

Counterpart of ``repro/bo/sampler.py``, host pipeline.  Each ``ask`` after
the startup trials standardizes y, fits a Matérn-5/2 GP by multi-start
MAP, materializes K⁻¹ for the fused posterior, draws restart points (the
incumbent plus B−1 uniform draws from the same numpy stream as the
reference), and maximizes LogEI with the chosen MSO strategy.

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
from repro_torch.core.mso import STRATEGIES, MsoOptions, MsoResult, \
    maximize_acqf
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.posterior import fused_logei_acq, resolve_backend
from repro_torch.gp.fit import fit_gp, standardize
from repro_torch.gp.gpr import with_kinv
from repro_torch.obs import trace as obs


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

    ``theta_init`` (optional) maps a fit seed to the (gp_fit_restarts, P)
    θ inits of that trial's MAP fit, in place of ``theta_init_grid``'s
    ``torch.Generator`` draws; the parity tests hand in the reference's.
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
        device=None,
        theta_init: Optional[Callable[[int], np.ndarray]] = None,
    ):
        if strategy == "dbe_vec":
            raise _not_ported("strategy 'dbe_vec'", "queue A item 5")
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        if fused:
            raise _not_ported("the fused one-program ask()",
                              "queue A item 8")
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
        self.theta_init = theta_init
        self.posterior_backend = resolve_backend(posterior_backend,
                                                 self.device)
        # ONE evaluation engine for the whole BO run
        self._acq_fn = (logei_acq if self.posterior_backend == "cholesky"
                        else fused_logei_acq(self.posterior_backend))
        self.engine = EvalEngine(self._acq_fn, device=self.device)
        self.trials: List[Trial] = []
        self.stats = SamplerStats()
        self.last_mso: Optional[MsoResult] = None
        self.last_acq_state = None       # (GPState, best) of last ask

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

    def _suggest(self) -> np.ndarray:
        X, y = self._observations()
        U = self.space.to_unit(X)
        dev = self.device
        fit_seed = self.seed + len(self.trials)
        # minimize y == maximize -y (standardized)
        t0 = time.perf_counter()
        with obs.span("ask.phase.standardize", n=len(y)):
            y_std, _, _ = standardize(torch.as_tensor(-y).to(dev))
        with obs.span("ask.phase.refit", n=len(y)):
            thetas = (None if self.theta_init is None else torch.tensor(
                np.asarray(self.theta_init(fit_seed), np.float64)))
            gp = fit_gp(torch.as_tensor(U).to(dev), y_std,
                        n_restarts=self.gp_fit_restarts, seed=fit_seed,
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
            rand = self.rng.uniform(0.0, 1.0, (self.B - 1, self.space.dim))
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


class FleetSampler:
    """Many studies behind one fleet: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("FleetSampler", "queue A item 9")
