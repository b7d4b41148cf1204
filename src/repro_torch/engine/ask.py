"""The fused device-resident ask() pipeline.

Counterpart of ``repro/engine/ask.py``.  One :class:`AskEngine` owns the
whole suggest path of a BO trial as two counted programs per GP size
bucket:

* **full program**: masked standardize → multi-start MAP hyperparameter
  fit (``gp.fit.fit_padded_core``, θ warm-started from the previous trial;
  on the card every objective evaluation is one gram kernel K3 forward and
  one K4 backward) → K⁻¹ (fused posterior backend) → restart points →
  lockstep L-BFGS-B MSO (LogEI through the posterior kernels K1/K2) →
  argmax.  Runs at bucket boundaries, every ``refit_interval`` trials, and
  as the exactness fallback.
* **incremental program**: masked standardize → rank-one Cholesky /
  bordered-K⁻¹ append (``gp.fit.incremental_update``, O(n²), fixed θ; the
  cross column is one K3 launch) → the same MSO tail.  Runs on every other
  trial: no O(n³) refactorization and no MAP optimization.

Trial-to-trial state (padded X/y buffers, θ, Cholesky factor, K⁻¹) stays
on the device between calls; a suggest sends the restart draws in and
brings ``best_x`` and scalar diagnostics back.  JAX donates the factor
buffers to update them in place; here every update is functional (new
tensors), so a :class:`GPState` taken earlier (``gp_state()``) never
changes under its holder.  Both programs are :class:`CountingJit`s, so
"programs per run" stays an exact O(#size-buckets) metric.

Unlike the reference, where the incremental program always runs its MSO
and the host then reads ``ok``, the port reads ``ok`` (one host sync)
before the MSO and skips it on a fallback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lbfgsb import LbfgsbOptions, lbfgsb_minimize
from repro_torch.engine.cache import CountingJit, retrace_report
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.plan import EvalPlan
from repro_torch.gp.fit import (FIT_OPTS, _FAR, fit_padded_core,
                                incremental_update, pad_bucket_for,
                                standardize_masked, theta_bounds,
                                theta_init_grid, unpack_theta)
from repro_torch import by_study
from repro_torch.gp.gpr import GPState, kinv_from_chol
from repro_torch.gp.kernels import KernelParams
from repro_torch.kernels.matern.kernel import launch_counts
from repro_torch.obs import trace as obs

Tensor = torch.Tensor

# paper-style MSO defaults (mirrors core.mso.MsoOptions)
_MSO_DEFAULT = LbfgsbOptions(m=10, maxiter=200, pgtol=1e-2, ftol=0.0,
                             maxls=25)


@dataclass(frozen=True)
class AskConfig:
    """Static description of one fused ask pipeline."""
    dim: int
    n_restarts: int = 10             # B: incumbent + (B-1) uniform
    kernel: str = "matern52"
    backend: str = "cholesky"        # resolved posterior backend
    pad_bucket: int = 32             # GP size-bucket quantum
    refit_interval: int = 8          # full MAP refit cadence (≥1)
    warm_start: bool = True          # seed the MAP fit from previous θ
    gp_fit_restarts: int = 2
    gp_fit_maxiter: int = 60
    mso: LbfgsbOptions = _MSO_DEFAULT

    def __post_init__(self):
        if self.refit_interval < 1:
            raise ValueError("refit_interval must be >= 1")
        if self.n_restarts < 2:
            raise ValueError("n_restarts must be >= 2")


class SuggestInfo(NamedTuple):
    """Per-trial diagnostics.  The first five fields are the reference's;
    the port adds the fit's evaluation count and the two phases' times."""
    kind: str            # "full" | "incremental" | "fallback"
    n_iters: Tensor      # (B,) QN iterations per restart
    n_evals: Tensor      # (B,) active objective evals per restart
    rounds: int          # batched evaluation rounds of the MSO
    best_acq: Tensor     # ()  acquisition value at the suggestion
    fit_evals: int = 0   # MAP-fit objective evaluations (0: incremental)
    # host ms of the refit (full or rank-one) and of restart points + MSO
    # + argmax, synchronized; measured only while the obs tracer is on
    fit_ms: float = 0.0
    mso_ms: float = 0.0


def _phase_ms(program: str, *clocks: Optional[float]) -> dict:
    """``fit_ms`` (and ``mso_ms``) between consecutive synced tracer
    clocks (``obs.synced_now_us``), each phase also recorded as a span;
    0.0 when tracing was off, and then no clock was read or synced."""
    ms = {"fit_ms": 0.0, "mso_ms": 0.0}
    tr = obs.get()
    if tr is None or None in clocks:
        return ms
    for phase, t0, t1 in zip(("fit", "mso"), clocks, clocks[1:]):
        ms[f"{phase}_ms"] = (t1 - t0) / 1e3
        tr.record_span(f"ask.phase.{phase}", t0, t1 - t0, program=program)
    return ms


# ---------------------------------------------------------------------------
# the per-study halves of the suggest pipeline, as functions of one padded
# study (AskEngine) or of S stacked studies (the fleet plane, which JAX gets
# by vmapping them): x (S, b, D), y (S, b), n_valid an (S,) tensor, θ and
# the factors leading with S
# ---------------------------------------------------------------------------

def _valid(x: Tensor, n_valid) -> Tensor:
    """(b,) or (S, b) mask of the live rows: ``n_valid`` an int or an (S,)
    tensor of per-slot counts."""
    n = torch.as_tensor(n_valid, device=x.device)
    return torch.arange(x.shape[-2], device=x.device) < n[..., None]


def refit_core(x, y, n_valid, thetas, tlo, tup, *, dim: int,
               kernel: str, backend: str, fit_opts: LbfgsbOptions):
    """Full-refit core: masked standardize → multi-start MAP fit → (for
    the fused posterior backend) K⁻¹.

    Returns ``(y_std, valid, theta, chol, alpha, kinv, fit_evals)`` with
    ``kinv`` ``None`` on the ``"cholesky"`` backend; ``fit_evals`` (the
    fit's batched objective evaluations) is the port's addition.  Stacked,
    θ inits and bounds are (S, R, P) and every study's fit shares one
    lockstep solve.
    """
    valid = _valid(x, n_valid)
    y_std, _, _ = standardize_masked(-y, valid)
    theta, chol, alpha, _, fit_evals = fit_padded_core(
        x, y_std, valid, thetas, tlo, tup,
        dim=dim, kernel=kernel, opts=fit_opts)
    kinv = None
    if backend != "cholesky":
        kinv = by_study(kinv_from_chol, chol, stacked=x.ndim == 3)
    return y_std, valid, theta, chol, alpha, kinv, fit_evals


def incr_core(x, y, n_valid, theta, chol, kinv, *, dim: int,
              kernel: str):
    """Incremental-refit core: masked standardize → rank-one Cholesky /
    bordered-K⁻¹ append at fixed θ (O(n²)); stacked, each slot appends
    its own row ``n_valid[s] − 1``.

    Returns ``(y_std, valid, params, chol, alpha, kinv, ok)``; ``ok``
    flags a numerically sound Schur complement (callers fall back to
    :func:`refit_core` when it is False).
    """
    valid = _valid(x, n_valid)
    y_std, _, _ = standardize_masked(-y, valid)
    params = unpack_theta(theta, dim)
    chol_new, alpha, kinv_new, ok = incremental_update(
        x, y_std, n_valid, params, chol, kinv, kernel=kernel)
    return y_std, valid, params, chol_new, alpha, kinv_new, ok


def restart_points(draws: Tensor, x: Tensor, y_std: Tensor, valid: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """Restart stack: the incumbent + the (B−1, D) uniform ``draws``.

    Returns ``(x0 (B, D), best_val)``, the incumbent's standardized,
    maximization-scale objective value; stacked, (S, B, D) and (S,).
    """
    masked = torch.where(valid, y_std, -torch.inf)
    best_val = masked.max(-1).values
    i = torch.argmax(masked, -1)
    inc = torch.take_along_dim(x, i[..., None, None], -2)      # (..., 1, D)
    return torch.cat([inc, draws], -2), best_val


class AskEngine:
    """Fused ask(): observe() appends, suggest() runs one device program.

    ``fault_injector`` (optional) may veto an incremental update's ``ok``
    flag through ``incr_ok(ok: np.ndarray, tags: list) -> np.ndarray``, to
    force the full-refit fallback deterministically.
    """

    def __init__(self, engine: EvalEngine, cfg: AskConfig,
                 fault_injector=None):
        self.engine = engine
        self.cfg = cfg
        self.fault_injector = fault_injector
        self.device = engine.device
        self._plan = EvalPlan.for_batch(cfg.n_restarts, cfg.dim)
        self._fit_opts = FIT_OPTS._replace(maxiter=cfg.gp_fit_maxiter)
        self._full_prog = CountingJit(self._full_impl, name="full")
        self._incr_prog = CountingJit(self._incr_impl, name="incr")
        # device-completion spans when the obs tracer is on
        self._full_prog = obs.ProgramTimer(self._full_prog,
                                           "ask.program.full")
        self._incr_prog = obs.ProgramTimer(self._incr_prog,
                                           "ask.program.incr")

        # trial-to-trial device state
        self._x: Optional[Tensor] = None      # (b, D) padded observations
        self._y: Optional[Tensor] = None      # (b,)  raw objective values
        self._n = 0                           # live observation count
        self._theta: Optional[Tensor] = None  # (P,) fitted log-hypers
        self._chol: Optional[Tensor] = None   # (b, b) padded factor
        self._alpha: Optional[Tensor] = None  # (b,)
        self._kinv: Optional[Tensor] = None   # (b, b) (fused backend)
        self._n_fit = 0                       # observations in the factor
        self._since_refit = 0
        # economy counters
        self.n_full_refits = 0
        self.n_incremental = 0
        self.n_fallbacks = 0

    # ----------------------------------------------------------- host api
    @property
    def n_obs(self) -> int:
        return self._n

    @property
    def bucket(self) -> int:
        return 0 if self._x is None else self._x.shape[0]

    def observe(self, x_unit: np.ndarray, y: float) -> None:
        """Append one observation (unit-cube x, raw minimized y)."""
        x_unit = np.asarray(x_unit, np.float64).reshape(self.cfg.dim)
        n_new = self._n + 1
        b_needed = pad_bucket_for(n_new, self.cfg.pad_bucket)
        if self._x is None or b_needed > self._x.shape[0]:
            self._grow(b_needed)
        # functional: a GPState handed out earlier keeps its buffers
        x, y_buf = self._x.clone(), self._y.clone()
        x[self._n] = torch.as_tensor(x_unit).to(self.device)
        y_buf[self._n] = float(y)
        self._x, self._y, self._n = x, y_buf, n_new

    def _grow(self, b: int) -> None:
        """Move to a larger pad bucket; invalidates the factor state (the
        next suggest() takes the full program, by design the only trials
        that pay an O(n³) cost or a new program signature)."""
        D, dev, dt = self.cfg.dim, self.device, torch.float64
        x = torch.full((b, D), _FAR, dtype=dt, device=dev) + \
            torch.arange(b, dtype=dt, device=dev)[:, None]
        y = torch.zeros((b,), dtype=dt, device=dev)
        if self._x is not None:
            x[:self._n] = self._x[:self._n]
            y[:self._n] = self._y[:self._n]
        self._x, self._y = x, y
        self._chol = self._alpha = self._kinv = None

    def suggest(self, draws, fit_seed: int, theta_draws=None
                ) -> Tuple[np.ndarray, SuggestInfo]:
        """One fused ask: returns (unit-cube best_x, diagnostics).

        ``draws`` ((B−1, D), U[0, 1)) are the restart points beside the
        incumbent; ``fit_seed`` seeds the MAP multi-start jitter (matching
        ``fit_gp(seed=...)``), or ``theta_draws`` ((R−1, P)) gives it.
        """
        if self._n < 2:
            raise ValueError(
                f"suggest() needs >= 2 observations, have {self._n}")
        tr = obs.get()
        t_start = tr.now_us() if tr is not None else 0.0
        if not isinstance(draws, torch.Tensor):
            draws = torch.tensor(np.asarray(draws, np.float64))
        draws = draws.to(self.device, torch.float64)
        before = launch_counts()

        # refit_interval=k ⇒ a full MAP refit every k-th suggest
        # (k=1: every trial, i.e. incremental updates disabled)
        incremental = (self._chol is not None
                       and self._n - self._n_fit == 1
                       and self._since_refit < self.cfg.refit_interval - 1)
        kind = "incremental"
        incr_ms = 0.0
        if incremental:
            best_x, chol, alpha, kinv, ok, stats = self._incr_prog(
                draws, self._x, self._y, self._n,
                self._theta, self._chol, self._kinv)
            if ok:
                self._chol, self._alpha, self._kinv = chol, alpha, kinv
                self._since_refit += 1
                self.n_incremental += 1
            else:                     # exactness fallback: refit for real
                self.n_fallbacks += 1
                self.engine.record_refit_fallback()
                incremental = False
                kind = "fallback"
                incr_ms = stats["fit_ms"]

        if not incremental:
            init = None
            if self.cfg.warm_start and self._theta is not None:
                init = unpack_theta(self._theta, self.cfg.dim)
            with obs.span("ask.phase.theta_grid",
                          restarts=self.cfg.gp_fit_restarts):
                thetas = theta_init_grid(self.cfg.dim, torch.float64,
                                         self.cfg.gp_fit_restarts, fit_seed,
                                         init=init, draws=theta_draws,
                                         device=self.device)
            tlo, tup = theta_bounds(self.cfg.dim, torch.float64, self.device)
            best_x, theta, chol, alpha, kinv, stats = self._full_prog(
                draws, self._x, self._y, self._n, thetas,
                tlo.expand(thetas.shape), tup.expand(thetas.shape))
            self._theta = theta
            self._chol, self._alpha, self._kinv = chol, alpha, kinv
            self._since_refit = 0
            self.n_full_refits += 1
            kind = "full" if kind == "incremental" else kind
            stats["fit_ms"] += incr_ms

        self.engine.stats.count_launches_since(before)
        self._n_fit = self._n
        info = SuggestInfo(kind=kind, n_iters=stats["k"],
                           n_evals=stats["n_evals"], rounds=stats["rounds"],
                           best_acq=stats["best_acq"],
                           fit_evals=stats["fit_evals"],
                           fit_ms=stats["fit_ms"], mso_ms=stats["mso_ms"])
        # the in-program lockstep solve bypasses run_lockstep, so feed
        # the shared EngineStats economy counters here
        self.engine.record_lockstep_economy(self.cfg.n_restarts,
                                            info.rounds, info.n_evals)
        if tr is not None:
            tr.record_span("ask.suggest", t_start, tr.now_us() - t_start,
                           kind=kind, n=self._n, bucket=self.bucket)
        return best_x.cpu().numpy(), info

    def gp_state(self) -> GPState:
        """The current fitted GPState (tests/introspection).  Its tensors
        are the engine's own, which later updates replace, never write."""
        if self._chol is None:
            raise ValueError("no fitted state yet")
        valid = torch.arange(self.bucket, device=self.device) < self._n_fit
        y_std, _, _ = standardize_masked(-self._y, valid)
        return GPState(x_train=self._x, y_train=y_std,
                       params=unpack_theta(self._theta, self.cfg.dim),
                       chol=self._chol, alpha=self._alpha,
                       kernel=self.cfg.kernel, kinv=self._kinv)

    def stats_snapshot(self) -> dict:
        return {
            "n_full_refits": self.n_full_refits,
            "n_incremental": self.n_incremental,
            "n_fallbacks": self.n_fallbacks,
            "n_full_compiles": self._full_prog.n_compiles,
            "n_incr_compiles": self._incr_prog.n_compiles,
            "n_ask_compiles": (self._full_prog.n_compiles
                               + self._incr_prog.n_compiles),
            "retraces": retrace_report({"full": self._full_prog,
                                        "incr": self._incr_prog}),
        }

    # ------------------------------------------------------- device side
    def _mso_tail(self, draws, x, y_std, valid, params: KernelParams,
                  chol, alpha, kinv):
        """Shared back half of both programs: restart points → lockstep
        MSO → selection.  Mirrors the host pipeline exactly (incumbent +
        (B−1) uniform restarts, LogEI maximization, argmax over final f)."""
        cfg = self.cfg
        gp = GPState(x_train=x, y_train=y_std, params=params, chol=chol,
                     alpha=alpha, kernel=cfg.kernel, kinv=kinv)
        x0, best_val = restart_points(draws, x, y_std, valid)
        fun = self.engine.device_fun((gp, best_val), self._plan)
        res = lbfgsb_minimize(fun, x0, torch.zeros_like(x0),
                              torch.ones_like(x0), cfg.mso)
        best = torch.argmax(-res.f)
        stats = {"k": res.k, "n_evals": res.n_evals, "rounds": res.rounds,
                 "best_acq": -res.f[best]}
        return res.x[best], stats

    def _full_impl(self, draws, x, y, n_valid, thetas, tlo, tup):
        D = x.shape[1]
        t0 = obs.synced_now_us()
        y_std, valid, theta, chol, alpha, kinv, fit_evals = refit_core(
            x, y, n_valid, thetas, tlo, tup, dim=D, kernel=self.cfg.kernel,
            backend=self.cfg.backend, fit_opts=self._fit_opts)
        t1 = obs.synced_now_us()
        params = unpack_theta(theta, D)
        best_x, stats = self._mso_tail(draws, x, y_std, valid, params,
                                       chol, alpha, kinv)
        t2 = obs.synced_now_us()
        stats.update(fit_evals=fit_evals, **_phase_ms("full", t0, t1, t2))
        return best_x, theta, chol, alpha, kinv, stats

    def _incr_impl(self, draws, x, y, n_valid, theta, chol, kinv):
        D = x.shape[1]
        t0 = obs.synced_now_us()
        y_std, valid, params, chol_new, alpha, kinv_new, ok = incr_core(
            x, y, n_valid, theta, chol, kinv, dim=D, kernel=self.cfg.kernel)
        ok = bool(ok)
        if self.fault_injector is not None:
            ok = bool(self.fault_injector.incr_ok(np.asarray([ok]),
                                                  [None])[0])
        t1 = obs.synced_now_us()
        if not ok:
            return None, chol_new, alpha, kinv_new, False, _phase_ms(
                "incr", t0, t1)
        best_x, stats = self._mso_tail(draws, x, y_std, valid, params,
                                       chol_new, alpha, kinv_new)
        t2 = obs.synced_now_us()
        stats.update(fit_evals=0, **_phase_ms("incr", t0, t1, t2))
        return best_x, chol_new, alpha, kinv_new, True, stats
