"""The fleet ask plane: multi-study suggest with slot-based continuous
batching.

Counterpart of ``repro/engine/fleet.py``.  The fused ask (``engine/ask.py``)
serves one study; at BO sizes (B ≈ 10 restarts) each of its rounds leaves
the card nearly idle and costs milliseconds of host time.  The fleet
stacks S whole studies along a leading axis and serves every study's
``suggest()`` of a slot block from three counted programs per (GP size
bucket, slot count):

* **stacked study state**: per-slot padded ``x (S, b, D)`` / ``y (S, b)``
  buffers with per-slot observation counts, θ ``(S, P)``, Cholesky
  factors ``(S, b, b)`` and (fused backend) K⁻¹ ``(S, b, b)``;
* **study-batched GP cores**: ``refit_core`` / ``incr_core`` take the
  stack with an ``(S,)`` tensor of per-slot counts where JAX vmaps them:
  one MAP-fit evaluation is one gram for all S·R θ rows (on the card one
  K3 and one K4 launch), a rank-one update one K3 launch for all slots;
* **one lockstep solve for the block**: per-slot restart points feed one
  ``(S, B, D)`` L-BFGS-B solve, so an MSO round is one K1 and one K2
  launch for every study of the block;
* **slot-based continuous batching**: fixed slot blocks grouped by pad
  bucket, queued studies admitted at trial boundaries, studies migrating
  blocks on bucket growth (host-side compaction, θ carried for warm
  starts), idle slots held on benign ``_FAR`` rows.  Blocks of one
  (bucket, slots) shape share the programs, so the program count depends
  on the bucket ladder, never on the number of studies.

Exactness: every stacked operation works on each slot's own rows, and the
lockstep solver freezes converged rows, so at a pinned ``slots`` width a
study's trajectory is bitwise independent of its slot and of which other
studies share the block.  Across widths (the solo ``AskEngine`` against
the fleet) a batched Cholesky or product may round differently, so the
two agree to 1e-10, as in the reference.

The robustness layer is the reference's: admission caps
(``max_studies``/``max_queue``/``max_blocks``/``admission_timeout``),
load shedding, quarantine of the newest observation after an unhealthy
full refit with bounded, jittered backoff through ``sleep_fn``, parking,
and a write-ahead ``journal`` of admissions, migrations, refit θs,
quarantines and sheds.  ``fault_injector`` may veto the incremental and
full-refit health flags and inject refit latency (``incr_ok``,
``full_ok``, ``full_delay``).

**Mesh sharding.**  Pass ``mesh=`` (a 1-D ``"study"`` mesh from
``launch.mesh.make_fleet_mesh``, or a :class:`~repro_torch.launch.mesh.Mesh`
that repeats a card) and every slot block widens to ``cfg.slots × ndev``
rows: device d owns the ``cfg.slots`` contiguous slots ``[d·slots,
(d+1)·slots)``, every leaf of the block is
:class:`~repro_torch.distributed.sharding.Sharded` along the slot axis,
and the three block programs run shard by shard, each under its own
device and with its own lockstep MSO loop, so each device refits and
solves only its own rows.  Every shard runs the same fixed-width program
on exactly ``cfg.slots`` rows whatever the mesh's size, which with C14's
study-by-study rule makes a study's bits independent of its placement.
The scheduler balances admissions over per-device occupancy; bucket
growth goes through the same evict → host-compact → re-admit path, which
is also the cross-device move.  A counted call is a block's, over all of
its shards, so program counts do not depend on the device count.
Without a mesh the fleet is a mesh of one entry, the engine's device.
Shards run one after another on the host.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lbfgsb import LbfgsbOptions, lbfgsb_minimize
from repro_torch.distributed.sharding import (Sharded, fleet_shard,
                                              fleet_shards)
from repro_torch.engine.ask import (_MSO_DEFAULT, SuggestInfo, incr_core,
                                    refit_core, restart_points)
from repro_torch.engine.cache import CountingJit, retrace_report
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.plan import EvalPlan
from repro_torch.gp.fit import (FIT_OPTS, _FAR, pad_bucket_for,
                                standardize_masked, theta_bounds,
                                theta_init_grid, unpack_theta)
from repro_torch.gp.gpr import GPState
from repro_torch.kernels.matern.kernel import launch_counts
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import trace as obs

Tensor = torch.Tensor


class FleetFullError(RuntimeError):
    """Admission rejected: the fleet is at its configured capacity
    (``max_studies`` / ``max_queue``).  Callers surface the rejection or
    degrade to the solo :class:`~repro_torch.engine.ask.AskEngine` path
    (``FleetSampler(degrade_to_solo=True)``)."""


class FleetStudyError(RuntimeError):
    """A study left the fleet (load-shed past its admission deadline, or
    parked after exhausting quarantine retries).  Sync callers get it
    raised; async callers receive it through ``pop_result`` in place of a
    suggestion."""


@dataclass(frozen=True)
class FleetConfig:
    """Static description of one fleet ask plane (a fleet serves studies
    that share it)."""
    dim: int
    n_restarts: int = 10             # B: incumbent + (B-1) uniform
    slots: int = 8                   # slot-block width
    kernel: str = "matern52"
    backend: str = "cholesky"        # resolved posterior backend
    pad_bucket: int = 32             # GP size-bucket quantum
    refit_interval: int = 8          # full MAP refit cadence (≥1)
    warm_start: bool = True          # seed MAP fits from the slot's prev θ
    gp_fit_restarts: int = 2
    gp_fit_maxiter: int = 60
    mso: LbfgsbOptions = _MSO_DEFAULT
    # robustness knobs: host-side scheduling and retry policy only, so
    # changing them never adds a program
    max_studies: Optional[int] = None    # live-study cap (admission gate)
    max_queue: Optional[int] = None      # registration-queue cap
    max_blocks: Optional[int] = None     # slot-block cap (device memory)
    admission_timeout: Optional[float] = None   # seconds queued → shed
    quarantine_retries: int = 2          # bad-refit retries before parking
    # bounded exponential backoff between quarantine retries (0: none),
    # with jitter from a host RNG of the engine's own
    retry_backoff_base: float = 0.0
    retry_backoff_cap: float = 2.0
    retry_backoff_jitter: float = 0.25

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.refit_interval < 1:
            raise ValueError("refit_interval must be >= 1")
        if self.n_restarts < 2:
            raise ValueError("n_restarts must be >= 2")
        if self.quarantine_retries < 0:
            raise ValueError("quarantine_retries must be >= 0")
        if self.retry_backoff_base < 0.0:
            raise ValueError("retry_backoff_base must be >= 0")


class _Study:
    """Host-side record of one study: observations (the source of truth
    for admission and migration), slot, refit bookkeeping, mailbox."""

    __slots__ = ("sid", "xs", "ys", "tags", "block", "slot", "n_fit",
                 "since_refit", "has_factor", "has_theta", "theta_host",
                 "trial", "pending", "result", "from_device", "deadline",
                 "shed", "parked")

    def __init__(self, sid: Hashable):
        self.sid = sid
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []
        self.tags: List[Optional[Hashable]] = []   # caller trial ids
        self.block: Optional["_Block"] = None
        self.slot = -1
        self.n_fit = 0
        self.since_refit = 0
        self.has_factor = False          # factor rows valid (incr eligible)
        self.has_theta = False           # θ row fitted (warm-start eligible)
        self.theta_host: Optional[np.ndarray] = None   # carried on migration
        self.trial = 0                   # suggest counter (default draws)
        # (restart draws (B-1, D), fit seed, θ-grid draws or None)
        self.pending: Optional[Tuple[Tensor, int, Optional[np.ndarray]]] = None
        self.result = None  # (x, SuggestInfo) | FleetStudyError | None
        self.from_device: Optional[int] = None   # device before migration
        self.deadline: Optional[float] = None    # admission deadline (mono)
        self.shed: Optional[str] = None          # load-shed reason
        self.parked: Optional[str] = None        # quarantine-parked reason

    @property
    def n(self) -> int:
        return len(self.ys)


# Idle slots carry this many benign pseudo-observations: the _FAR pattern
# gives a ~diagonal gram, zero standardized targets and a fast-converging
# frozen row, never NaNs that would stall the shared lockstep loops.
_IDLE_N = 2


class _Block:
    """One slot block: ``cfg.slots`` studies on each mesh device
    (``cfg.slots × ndev`` slots in all), padded to one GP size bucket.
    Every leaf is :class:`Sharded` along the slot axis, so each device
    holds and runs exactly ``cfg.slots`` rows.  Blocks of equal (bucket,
    slots) share the fleet's programs."""

    def __init__(self, cfg: FleetConfig, bucket: int, mesh: Mesh):
        S, b, D = cfg.slots * mesh.size, bucket, cfg.dim
        f64 = dict(dtype=torch.float64)
        self.bucket = bucket
        self.mesh, self.rows = mesh, cfg.slots
        self.idle_x = np.full((b, D), _FAR) + np.arange(b)[:, None]
        th0 = np.zeros((D + 2,))
        th0[-1] = -4.0                               # theta_init_grid base
        self.theta0 = th0
        eye = torch.eye(b, **f64).expand(S, b, b).contiguous()
        self.x, self.y, self.theta, self.chol, self.alpha, self.kinv = \
            fleet_shards(mesh, (
                torch.as_tensor(np.tile(self.idle_x[None], (S, 1, 1))),
                torch.zeros((S, b), **f64),
                torch.as_tensor(np.tile(th0[None], (S, 1))), eye,
                torch.zeros((S, b), **f64),
                None if cfg.backend == "cholesky" else eye), cfg.slots)
        self.studies: List[Optional[_Study]] = [None] * S

    def n_valid(self) -> Sharded:
        nv = [_IDLE_N if st is None else st.n for st in self.studies]
        return fleet_shard(self.mesh, torch.tensor(nv, dtype=torch.int64),
                           self.rows)


def default_draws(sid: Hashable, trial: int, n: int, dim: int) -> Tensor:
    """The fleet's own restart stream for a study that brings none:
    (n, D) U[0, 1) from a generator seeded by (crc32 of the sid, trial),
    on the CPU.  crc32, not ``hash()``, so a string sid gives the same
    stream in every process."""
    tag = zlib.crc32(repr(sid).encode()) & 0x7FFFFFFF
    key = np.random.SeedSequence([tag, trial]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    return torch.rand((n, dim), generator=gen, dtype=torch.float64)


class FleetEngine:
    """Serve S concurrent studies' ask() from one set of programs.

    A request/step/result cycle (continuous batching, like
    ``serve.ServeEngine``): ``observe()`` appends per-study observations,
    ``request_suggest()`` enqueues a study's next ask, ``step()`` admits
    queued studies and runs the fused programs once per block holding
    requests, and ``pop_result()`` collects each suggestion.
    ``suggest()`` wraps the cycle for a synchronous caller; other studies'
    pending requests ride along in the same step.

    ``mesh`` (optional): a 1-D study :class:`Mesh`.  Slot blocks then span
    ``cfg.slots`` slots on every mesh device and the block programs run
    shard by shard (module docstring); trajectories are bit for bit those
    of the unsharded fleet, and a bucket-growth migration becomes a
    cross-device move when the new slot lives on another device.
    """

    def __init__(self, engine: EvalEngine, cfg: FleetConfig,
                 mesh: Optional[Mesh] = None, journal=None,
                 fault_injector=None, sleep_fn=None):
        if mesh is not None and len(mesh.axis_names) != 1:
            raise ValueError("fleet mesh must be 1-D (the study axis); "
                             f"got axes {mesh.axis_names}")
        self.engine = engine
        self.cfg = cfg
        self.mesh = mesh
        self.device = engine.device
        # the shards' devices: unsharded, one entry of the engine's device
        self._mesh = mesh if mesh is not None else Mesh([engine.device])
        self._ndev = self._mesh.size
        self._slots_total = cfg.slots * self._ndev
        self._sleep = time.sleep if sleep_fn is None else sleep_fn
        self._backoff_rng = np.random.default_rng(0xB0)
        # durability and chaos hooks, both host-side and optional:
        # ``journal`` duck-types StudyJournal.append; ``fault_injector``
        # may veto health flags and inject refit latency
        self.journal = journal
        self.fault_injector = fault_injector
        # notified as (sid, trial_tag, reason) when an observation is
        # quarantined: FleetSampler marks the owning Trial
        self.on_quarantine: Optional[Callable] = None
        self._plan = EvalPlan.for_batch(cfg.n_restarts, cfg.dim)
        self._fit_opts = FIT_OPTS._replace(maxiter=cfg.gp_fit_maxiter)
        # three programs per (bucket, slots): full refit, incremental
        # refit, and the MSO tail, each run shard by shard on the mesh
        m = self._mesh
        self._full_prog = obs.ProgramTimer(
            CountingJit(self._full_impl, name="full", mesh=m),
            "fleet.program.full")
        self._incr_prog = obs.ProgramTimer(
            CountingJit(self._incr_impl, name="incr", mesh=m),
            "fleet.program.incr")
        self._mso_prog = obs.ProgramTimer(
            CountingJit(self._mso_impl, name="mso", mesh=m),
            "fleet.program.mso")
        self._studies: Dict[Hashable, _Study] = {}
        self._queue: List[_Study] = []       # awaiting a slot
        self._blocks: List[_Block] = []
        # economy counters
        self.n_full_refits = 0
        self.n_incremental = 0
        self.n_fallbacks = 0
        self.n_steps = 0
        self.n_admissions = 0
        self.n_migrations = 0
        self.n_migrations_intra = 0      # re-admitted on the same device
        self.n_migrations_cross = 0      # ... on a different device
        # the port's: batched fit evaluations, MSO rounds and block
        # programs, summed over shards (on the card each evaluation is one
        # K3 + one K4 launch, each round one K1 + one K2, and each full or
        # incremental shard program one more K3)
        self.n_fit_evals = 0
        self.n_mso_rounds = 0
        self.n_block_programs = {"full": 0, "incr": 0, "mso": 0}
        # robustness counters
        self.n_rejected = 0
        self.n_shed = 0
        self.n_quarantined = 0
        self.n_parked = 0
        self.n_retries = 0
        self.n_retry_backoffs = 0
        self.backoff_total_s = 0.0

    def _journal(self, record: dict) -> None:
        if self.journal is not None:
            self.journal.append(record)

    # ----------------------------------------------------------- host api
    def add_study(self, sid: Hashable,
                  deadline: Optional[float] = None) -> None:
        """Register a study; it is admitted to a slot at the next trial
        boundary once it has observations.  Raises
        :class:`FleetFullError` at the live-study or queue cap;
        ``deadline`` (``time.monotonic()`` value, default now +
        ``admission_timeout``) bounds its wait for a slot."""
        if sid in self._studies:
            raise ValueError(f"study {sid!r} already registered")
        cfg = self.cfg
        live = sum(1 for s in self._studies.values()
                   if s.shed is None and s.parked is None)
        reason = None
        if cfg.max_studies is not None and live >= cfg.max_studies:
            reason = (f"fleet full: {live} live studies "
                      f"(max_studies={cfg.max_studies})")
        elif (cfg.max_queue is not None
                and len(self._queue) >= cfg.max_queue):
            reason = (f"admission queue full: {len(self._queue)} waiting "
                      f"(max_queue={cfg.max_queue})")
        if reason is not None:
            self.n_rejected += 1
            self._journal({"op": "reject", "sid": sid, "reason": reason})
            obs.instant("fleet.reject", sid=str(sid), reason=reason)
            raise FleetFullError(reason)
        st = _Study(sid)
        if deadline is None and cfg.admission_timeout is not None:
            deadline = time.monotonic() + cfg.admission_timeout
        st.deadline = deadline
        self._studies[sid] = st
        self._queue.append(st)

    def observe(self, sid: Hashable, x_unit, y: float,
                tag: Optional[Hashable] = None) -> None:
        """Append one observation (unit-cube x, raw minimized y); ``tag``
        is the caller's trial id, named by a later quarantine.  Refuses
        non-finite values: one NaN would poison the block's stacked
        programs."""
        st = self._studies[sid]
        x_unit = np.asarray(x_unit, np.float64).reshape(self.cfg.dim)
        y = float(y)
        if not (np.all(np.isfinite(x_unit)) and np.isfinite(y)):
            raise ValueError(
                f"study {sid!r}: non-finite observation "
                f"(trial {tag!r}, y={y!r}) — report evaluation failures "
                f"with failed=True; they must never reach GP data")
        st.xs.append(x_unit)
        st.ys.append(y)
        st.tags.append(tag)
        blk = st.block
        if blk is None:
            return
        if pad_bucket_for(st.n, self.cfg.pad_bucket) > blk.bucket:
            # bucket migration: journal, evict, re-admit (compacted into a
            # larger block) at the next trial boundary
            self.n_migrations += 1
            self._journal({"op": "migrate", "sid": sid, "n": st.n})
            obs.instant("fleet.migrate", sid=str(sid), n=st.n)
            self._evict(st)
        else:
            i = st.n - 1
            blk.x[st.slot, i] = x_unit
            blk.y[st.slot, i] = y

    def request_suggest(self, sid: Hashable, draws=None,
                        fit_seed: Optional[int] = None,
                        theta_draws=None) -> None:
        """Enqueue one suggest for ``sid`` (no-op while one is pending or
        an uncollected result waits).  ``draws`` ((B−1, D), U[0, 1)) are
        the restart points beside the incumbent, by default
        :func:`default_draws` of (sid, trial); ``fit_seed`` (default the
        trial counter) seeds the MAP multi-start jitter, or
        ``theta_draws`` ((R−1, P)) gives it."""
        st = self._studies[sid]
        if st.shed is not None or st.parked is not None:
            state = "shed" if st.shed is not None else "parked"
            raise FleetStudyError(
                f"study {sid!r} left the fleet ({state}): "
                f"{st.shed or st.parked}")
        if st.pending is not None or st.result is not None:
            return
        if draws is None:
            draws = default_draws(sid, st.trial, self.cfg.n_restarts - 1,
                                  self.cfg.dim)
        draws = torch.tensor(np.array(draws, np.float64))
        if fit_seed is None:
            fit_seed = st.trial
        st.pending = (draws, int(fit_seed), theta_draws)

    def pop_result(self, sid: Hashable):
        """Collect (and clear) the study's suggestion, if ready."""
        st = self._studies[sid]
        res, st.result = st.result, None
        return res

    def cancel_request(self, sid: Hashable) -> bool:
        """Withdraw a study's pending request and any uncollected result
        (safe: the same draws and observations recompute the same
        suggestion).  Returns whether anything was withdrawn."""
        st = self._studies[sid]
        had = st.pending is not None or st.result is not None
        st.pending = None
        st.result = None
        return had

    def suggest(self, sid: Hashable, draws=None,
                fit_seed: Optional[int] = None, theta_draws=None):
        """Synchronous ask for one study: request → step → collect."""
        self.request_suggest(sid, draws, fit_seed, theta_draws)
        self.step()
        res = self.pop_result(sid)
        assert res is not None
        if isinstance(res, FleetStudyError):
            raise res
        return res

    def study_theta(self, sid: Hashable) -> Optional[np.ndarray]:
        """The study's last fully refit θ, or None before its first."""
        st = self._studies[sid]
        if st.block is not None and st.has_theta:
            return st.block.theta[st.slot].cpu().numpy()
        return None if not st.has_theta else st.theta_host

    def restore_theta(self, sid: Hashable, theta) -> None:
        """Re-seed a (not yet admitted) study's warm-start θ: recovery
        replays journaled refit θs through here."""
        st = self._studies[sid]
        st.theta_host = np.asarray(theta, np.float64)
        st.has_theta = True

    def study_state(self, sid: Hashable) -> Tuple[str, Optional[str]]:
        """(state, reason): ``live``/``queued`` with None, or
        ``shed``/``parked`` with the recorded reason."""
        st = self._studies[sid]
        if st.parked is not None:
            return "parked", st.parked
        if st.shed is not None:
            return "shed", st.shed
        return ("live", None) if st.block is not None else ("queued", None)

    def step(self) -> int:
        """One trial boundary: admit queued studies, then run the fused
        programs once per block holding requests.  Returns the number of
        suggestions produced."""
        self._admit()
        for st in self._queue:
            if st.pending is not None:
                st.pending = None      # drop the bad request: one broken
                raise ValueError(      # study must not wedge the fleet
                    f"study {st.sid!r} requested suggest() with "
                    f"{st.n} observations; needs >= 2")
        tr = obs.get()
        t0 = tr.now_us() if tr is not None else 0.0
        before = launch_counts()
        served = 0
        for blk in self._blocks:
            with obs.span("fleet.step_block", bucket=blk.bucket):
                served += self._step_block(blk)
        self.engine.stats.count_launches_since(before)
        if tr is not None and served:
            tr.record_span("fleet.step", t0, tr.now_us() - t0,
                           served=served, n_blocks=len(self._blocks))
        self.n_steps += 1 if served else 0
        return served

    def stats_snapshot(self) -> dict:
        progs = {"full": self._full_prog, "incr": self._incr_prog,
                 "mso": self._mso_prog}
        return {
            "n_studies": len(self._studies),
            "n_blocks": len(self._blocks),
            "n_full_refits": self.n_full_refits,
            "n_incremental": self.n_incremental,
            "n_fallbacks": self.n_fallbacks,
            "n_steps": self.n_steps,
            "n_admissions": self.n_admissions,
            "n_migrations": self.n_migrations,
            "n_migrations_intra": self.n_migrations_intra,
            "n_migrations_cross": self.n_migrations_cross,
            "n_rejected": self.n_rejected,
            "n_shed": self.n_shed,
            "n_quarantined": self.n_quarantined,
            "n_parked": self.n_parked,
            "n_retries": self.n_retries,
            "n_retry_backoffs": self.n_retry_backoffs,
            "backoff_total_s": round(self.backoff_total_s, 6),
            "n_devices": self._ndev,
            "slots_per_device": self._device_occupancy(),
            "queue_depth": len(self._queue),
            "n_full_compiles": self._full_prog.n_compiles,
            "n_incr_compiles": self._incr_prog.n_compiles,
            "n_mso_compiles": self._mso_prog.n_compiles,
            "n_fleet_compiles": sum(p.n_compiles for p in progs.values()),
            "n_fit_evals": self.n_fit_evals,
            "n_mso_rounds": self.n_mso_rounds,
            "n_block_programs": dict(self.n_block_programs),
            "retraces": retrace_report(progs),
        }

    # ------------------------------------------------------- scheduler
    def _shard(self, a) -> Sharded:
        """A host-built per-slot operand, split onto the mesh."""
        return fleet_shard(self._mesh, torch.as_tensor(a), self.cfg.slots)

    def _slot_device(self, slot: int) -> int:
        """Mesh device owning ``slot``: the slot axis splits into ndev
        contiguous shards of ``cfg.slots`` rows each."""
        return slot // self.cfg.slots

    def _device_occupancy(self) -> List[int]:
        """Live studies resident on each mesh device (all blocks)."""
        occ = [0] * self._ndev
        for blk in self._blocks:
            for s, st in enumerate(blk.studies):
                if st is not None:
                    occ[self._slot_device(s)] += 1
        return occ

    def _pick_slot(self, bucket: int) -> Optional[Tuple[_Block, int]]:
        """Balanced admission: among free slots of ``bucket`` blocks, the
        one whose device holds the fewest live studies (ties: earliest
        block, lowest slot; on one device, the first free slot)."""
        occ = self._device_occupancy()
        best = None
        for bi, blk in enumerate(self._blocks):
            if blk.bucket != bucket:
                continue
            for s, cur in enumerate(blk.studies):
                if cur is None:
                    key = (occ[self._slot_device(s)], bi, s)
                    if best is None or key < best[1]:
                        best = ((blk, s), key)
        return None if best is None else best[0]

    def _admit(self) -> None:
        still: List[_Study] = []
        now = time.monotonic()
        for st in self._queue:
            if st.shed is not None or st.parked is not None:
                continue                 # left the fleet while queued
            if st.n < 1:                 # nothing to pad yet: stay queued
                still.append(st)
                continue
            bucket = pad_bucket_for(st.n, self.cfg.pad_bucket)
            pick = self._pick_slot(bucket)
            if pick is None:
                if (self.cfg.max_blocks is not None
                        and len(self._blocks) >= self.cfg.max_blocks):
                    # no slot and no room to grow: shed waiters past their
                    # deadline, keep the rest queued
                    if st.deadline is not None and now > st.deadline:
                        self._shed(st, "admission deadline exceeded "
                                   f"({len(self._blocks)} blocks full)")
                    else:
                        still.append(st)
                    continue
                blk = _Block(self.cfg, bucket, self._mesh)
                self._blocks.append(blk)
                occ = self._device_occupancy()
                pick = (blk, min(range(self._slots_total),
                                 key=lambda s: (occ[self._slot_device(s)],
                                                s)))
            self._install(st, *pick)
            self.n_admissions += 1
        self._queue = still

    def _shed(self, st: _Study, reason: str) -> None:
        """Load-shed a queued study: it stops being schedulable; its
        sampler degrades to the solo path when it sees the state."""
        self.n_shed += 1
        self._journal({"op": "shed", "sid": st.sid, "reason": reason})
        obs.instant("fleet.shed", sid=str(st.sid), reason=reason)
        st.shed = reason
        st.pending = None

    def shed_study(self, sid: Hashable, reason: str) -> None:
        """Mark a registered study load-shed (the journal-replay path)."""
        st = self._studies[sid]
        if st.block is not None:
            self._clear_slot(st)
        if st.shed is None:
            self._shed(st, reason)

    def _install(self, st: _Study, blk: _Block, slot: int) -> None:
        """Host-side compaction: copy the study's observations into the
        block's padded slot row (θ carried for warm starts).  On a mesh
        this is the cross-device move: the row lands on whichever device
        owns the slot."""
        n = st.n
        x_row = np.array(blk.idle_x)
        x_row[:n] = np.stack(st.xs)
        y_row = np.zeros((blk.bucket,))
        y_row[:n] = st.ys
        blk.x[slot] = x_row
        blk.y[slot] = y_row
        if st.theta_host is not None:
            blk.theta[slot] = st.theta_host
        self._journal({"op": "admit", "sid": st.sid,
                       "bucket": blk.bucket, "slot": slot, "n": n})
        obs.instant("fleet.admit", sid=str(st.sid), bucket=blk.bucket,
                    slot=slot, n=n)
        blk.studies[slot] = st
        st.block, st.slot = blk, slot
        if st.from_device is not None:       # bucket-growth re-admission
            if self._slot_device(slot) == st.from_device:
                self.n_migrations_intra += 1
            else:
                self.n_migrations_cross += 1
            st.from_device = None

    def _clear_slot(self, st: _Study) -> None:
        """Free the study's slot: save θ for a warm start and reset the
        row to the benign idle pattern."""
        blk, s = st.block, st.slot
        if st.has_theta:
            # a copy: on the CPU the row's numpy view would see the reset
            st.theta_host = blk.theta[s].cpu().numpy().copy()
        blk.x[s] = blk.idle_x
        blk.y[s] = 0.0
        blk.theta[s] = blk.theta0
        eye = torch.eye(blk.bucket, dtype=torch.float64)
        blk.chol[s] = eye
        blk.alpha[s] = 0.0
        if blk.kinv is not None:
            blk.kinv[s] = eye
        blk.studies[s] = None
        st.block, st.slot = None, -1
        st.from_device = self._slot_device(s)
        st.has_factor = False            # the factor dies with the bucket

    def _evict(self, st: _Study) -> None:
        """Bucket migration: free the slot and re-queue for re-admission
        into a larger block."""
        self._clear_slot(st)
        self._queue.append(st)

    def _park(self, st: _Study, reason: str) -> None:
        """Retire a study the fleet cannot serve: free its slot and fail
        the pending request through the mailbox."""
        self.n_parked += 1
        self._journal({"op": "park", "sid": st.sid, "reason": reason})
        obs.instant("fleet.park", sid=str(st.sid), reason=reason)
        if st.block is not None:
            self._clear_slot(st)
        st.parked = reason
        st.pending = None
        st.result = FleetStudyError(f"study {st.sid!r} parked: {reason}")

    def _quarantine_newest(self, st: _Study, reason: str) -> None:
        """Drop the study's newest observation from GP data (journal
        first), reset its slot entry to the idle value, and park the study
        if fewer than two clean observations remain."""
        k = st.n - 1
        x_bad, y_bad, tag = st.xs[-1], st.ys[-1], st.tags[-1]
        self.n_quarantined += 1
        self._journal({"op": "quarantine", "sid": st.sid, "trial": tag,
                       "x": x_bad.tolist(), "y": y_bad, "reason": reason})
        obs.instant("fleet.quarantine", sid=str(st.sid), trial=str(tag),
                    reason=reason)
        st.xs.pop()
        st.ys.pop()
        st.tags.pop()
        blk, s = st.block, st.slot
        if blk is not None:
            blk.x[s, k] = blk.idle_x[k]
            blk.y[s, k] = 0.0
        st.n_fit = min(st.n_fit, st.n)
        st.has_factor = False        # the factor summed the dropped row
        if self.on_quarantine is not None:
            self.on_quarantine(st.sid, tag, reason)
        if st.n < 2 and st.block is not None:
            self._park(st, f"only {st.n} clean observations "
                       f"after quarantine")

    def _full_thetas(self, blk: _Block, pending: List[int],
                     theta_host: np.ndarray) -> Sharded:
        """(S, R, P) θ inits: each refitting slot's grid from its fit seed
        (warm-started from the snapshot θ), benign grids elsewhere."""
        cfg, dt = self.cfg, torch.float64
        R = cfg.gp_fit_restarts
        rows = []
        for s, st in enumerate(blk.studies):
            if s in pending:
                init = None
                if cfg.warm_start and st.has_theta:
                    init = unpack_theta(torch.as_tensor(theta_host[s]),
                                        cfg.dim)
                _, fit_seed, draws = st.pending
                rows.append(theta_init_grid(cfg.dim, dt, R, fit_seed,
                                            init=init, draws=draws))
            else:                        # masked-out slot: benign inits
                rows.append(theta_init_grid(cfg.dim, dt, R, 0))
        return self._shard(torch.stack(rows))

    def _step_block(self, blk: _Block) -> int:
        cfg = self.cfg
        req = [(s, st) for s, st in enumerate(blk.studies)
               if st is not None and st.pending is not None]
        if not req:
            return 0
        for s, st in req:
            if st.n < 2:
                st.pending = None      # drop, don't wedge (see step())
                raise ValueError(f"suggest() for study {st.sid!r} needs "
                                 f">= 2 observations, have {st.n}")
        S = self._slots_total
        sids = [None if st is None else st.sid for st in blk.studies]
        fit_evals = np.zeros((self._ndev,), np.int64)    # a shard each

        # refit_interval=k ⇒ a full MAP refit every k-th suggest per slot
        # (k=1: incremental updates off), AskEngine.suggest's predicate
        kind: Dict[int, str] = {}
        do_incr = np.zeros((S,), bool)
        for s, st in req:
            incremental = (st.has_factor and st.n - st.n_fit == 1
                           and st.since_refit < cfg.refit_interval - 1)
            do_incr[s] = incremental
            kind[s] = "incremental" if incremental else "full"

        if do_incr.any():
            blk.chol, blk.alpha, blk.kinv, ok = self._incr_prog(
                blk.x, blk.y, blk.n_valid(), blk.theta, blk.chol,
                blk.alpha, blk.kinv, self._shard(do_incr))
            self.n_block_programs["incr"] += self._ndev
            ok = ok.cpu().numpy()
            if self.fault_injector is not None:
                ok = self.fault_injector.incr_ok(ok, sids)
            for s, st in req:
                if not do_incr[s]:
                    continue
                if ok[s]:
                    st.since_refit += 1
                    self.n_incremental += 1
                else:                    # exactness fallback: refit for real
                    kind[s] = "fallback"
                    self.n_fallbacks += 1
                    self.engine.record_refit_fallback()

        full_slots = [s for s, _ in req if kind[s] != "incremental"]
        if full_slots:
            # ONE warm-start snapshot for the whole retry loop: a retry
            # must not warm-start from the unhealthy θ it is retrying
            theta_host = blk.theta.cpu().numpy()
            shape = (cfg.slots, cfg.gp_fit_restarts, cfg.dim + 2)
            bounds = [theta_bounds(cfg.dim, torch.float64, dev)
                      for dev in self._mesh.devices]
            tlo = Sharded([lo.expand(shape) for lo, _ in bounds])
            tup = Sharded([up.expand(shape) for _, up in bounds])
            pending_full = list(full_slots)
            for attempt in range(cfg.quarantine_retries + 1):
                thetas = self._full_thetas(blk, pending_full, theta_host)
                do_full = np.zeros((S,), bool)
                do_full[pending_full] = True
                (blk.theta, blk.chol, blk.alpha, blk.kinv, okf,
                 evals) = self._full_prog(
                    blk.x, blk.y, blk.n_valid(), thetas, tlo, tup,
                    self._shard(do_full), blk.theta, blk.chol, blk.alpha,
                    blk.kinv)
                self.n_block_programs["full"] += self._ndev
                self.n_fit_evals += sum(evals)
                fit_evals += evals
                fi = self.fault_injector
                if fi is not None and hasattr(fi, "full_delay"):
                    # injected refit latency, charged to the sleep hook
                    d = fi.full_delay([blk.studies[s].sid
                                       for s in pending_full])
                    if d > 0.0:
                        self._sleep(d)
                okf = okf.cpu().numpy()
                if fi is not None:
                    okf = fi.full_ok(okf, sids)
                bad = [s for s in pending_full if not okf[s]]
                for s in pending_full:
                    if okf[s]:
                        st = blk.studies[s]
                        st.since_refit = 0
                        st.has_theta = True
                        self.n_full_refits += 1
                        if self.journal is not None:
                            self._journal({
                                "op": "refit", "sid": st.sid,
                                "theta": blk.theta[s].cpu().tolist()})
                if not bad:
                    break
                # quarantine each unhealthy slot's newest observation and
                # refit just those slots: a pure data change, so retries
                # reuse the same program
                nxt = []
                for s in bad:
                    st = blk.studies[s]
                    self._quarantine_newest(
                        st, f"full refit unhealthy (attempt {attempt + 1})")
                    if st.block is None:     # parked mid-quarantine
                        continue
                    if attempt < cfg.quarantine_retries:
                        nxt.append(s)
                    else:
                        self._park(st, "quarantine retries exhausted "
                                   f"({cfg.quarantine_retries + 1} "
                                   f"unhealthy refits)")
                pending_full = nxt
                if not pending_full:
                    break
                # bounded exponential backoff (with jitter) before the
                # retry, so an unhealthy slot cannot hot-spin refits
                self.n_retries += len(pending_full)
                if cfg.retry_backoff_base > 0.0:
                    delay = min(cfg.retry_backoff_base * (2.0 ** attempt),
                                cfg.retry_backoff_cap)
                    delay *= 1.0 + (cfg.retry_backoff_jitter
                                    * float(self._backoff_rng.random()))
                    self.n_retry_backoffs += 1
                    self.backoff_total_s += delay
                    self._journal({"op": "backoff", "attempt": attempt + 1,
                                   "delay_s": delay,
                                   "sids": [blk.studies[s].sid
                                            for s in pending_full]})
                    obs.instant("fleet.backoff", attempt=attempt + 1,
                                delay_s=delay, n_studies=len(pending_full))
                    self._sleep(delay)
            # parked studies dropped their requests mid-phase
            req = [(s, st) for s, st in req if st.pending is not None]
            if not req:
                return 0

        # restart draws: each requester's own, a benign constant elsewhere
        draws = torch.full((S, cfg.n_restarts - 1, cfg.dim), 0.5,
                           dtype=torch.float64)
        for s, st in req:
            draws[s] = st.pending[0]
        best_x, stats = self._mso_prog(
            self._shard(draws), blk.x, blk.y, blk.n_valid(), blk.theta,
            blk.chol, blk.alpha, blk.kinv)
        self.n_block_programs["mso"] += self._ndev
        # each shard's own lockstep round count (devices loop apart)
        rounds = stats["rounds"]
        self.n_mso_rounds += sum(rounds)
        bx = best_x.cpu().numpy()                   # (S, D), a shard each
        k_arr, ev_arr = stats["k"].cpu(), stats["n_evals"].cpu()
        bacq = stats["best_acq"].cpu()
        for s, st in req:
            d = self._slot_device(s)
            st.n_fit = st.n
            st.has_factor = True
            st.trial += 1
            st.result = (bx[s], SuggestInfo(
                kind=kind[s], n_iters=k_arr[s], n_evals=ev_arr[s],
                rounds=rounds[d], best_acq=bacq[s],
                fit_evals=(int(fit_evals[d]) if kind[s] != "incremental"
                           else 0)))
            st.pending = None
        # frozen idle and non-requesting rows are the fleet's padding:
        # only requesters' evaluations count as live points
        ev_live = torch.zeros_like(ev_arr)
        for s, _ in req:
            ev_live[s] = ev_arr[s]
        self.engine.record_lockstep_economy(S * cfg.n_restarts,
                                            max(rounds), ev_live)
        return len(req)

    # ------------------------------------------------------- device side
    def _full_impl(self, x, y, n_valid, thetas, tlo, tup, do_full,
                   theta_old, chol_old, alpha_old, kinv_old):
        """Study-batched full refit; ``do_full`` masks which slots commit
        (the rest keep their previous state).  Also returns a per-slot
        health flag: a refit with non-finite θ/α or a broken Cholesky
        (NaN or non-positive diagonal) is not served; masked-out slots
        are vacuously healthy.  And the fit's batched evaluations."""
        cfg = self.cfg
        _, _, theta_n, chol_n, alpha_n, kinv_n, evals = refit_core(
            x, y, n_valid, thetas, tlo, tup, dim=cfg.dim, kernel=cfg.kernel,
            backend=cfg.backend, fit_opts=self._fit_opts)
        diag = torch.diagonal(chol_n, dim1=-2, dim2=-1)
        healthy = (torch.isfinite(theta_n).all(-1)
                   & torch.isfinite(alpha_n).all(-1)
                   & (torch.isfinite(diag) & (diag > 0.0)).all(-1))
        ok = healthy | ~do_full
        commit = do_full & ok

        def sel(new, old):
            m = commit.reshape((-1,) + (1,) * (new.ndim - 1))
            return torch.where(m, new, old)

        kinv = None if kinv_old is None else sel(kinv_n, kinv_old)
        return (sel(theta_n, theta_old), sel(chol_n, chol_old),
                sel(alpha_n, alpha_old), kinv, ok, evals)

    def _incr_impl(self, x, y, n_valid, theta, chol_old, alpha_old,
                   kinv_old, do_incr):
        """Study-batched rank-one refit; a slot commits only when it asked
        (``do_incr``) and its Schur complement is sound."""
        cfg = self.cfg
        _, _, _, chol_n, alpha_n, kinv_n, ok = incr_core(
            x, y, n_valid, theta, chol_old, kinv_old, dim=cfg.dim,
            kernel=cfg.kernel)
        commit = do_incr & ok

        def sel(new, old):
            m = commit.reshape((-1,) + (1,) * (new.ndim - 1))
            return torch.where(m, new, old)

        kinv = None if kinv_old is None else sel(kinv_n, kinv_old)
        return sel(chol_n, chol_old), sel(alpha_n, alpha_old), kinv, ok

    def _mso_impl(self, draws, x, y, n_valid, theta, chol, alpha, kinv):
        """The fleet MSO tail: per-slot restart points feed ONE (S, B, D)
        lockstep solve; a per-slot argmax picks the suggestions."""
        cfg = self.cfg
        valid = torch.arange(x.shape[1], device=x.device) < n_valid[:, None]
        y_std, _, _ = standardize_masked(-y, valid)
        x0, best_val = restart_points(draws, x, y_std, valid)
        gp = GPState(x_train=x, y_train=y_std,
                     params=unpack_theta(theta, cfg.dim), chol=chol,
                     alpha=alpha, kernel=cfg.kernel, kinv=kinv)
        fun = self.engine.fleet_device_fun((gp, best_val), self._plan)
        res = lbfgsb_minimize(fun, x0, torch.zeros_like(x0),
                              torch.ones_like(x0), cfg.mso)
        best = torch.argmax(-res.f, dim=1)                      # (S,)
        best_x = torch.take_along_dim(res.x, best[:, None, None], 1)[:, 0]
        best_acq = -torch.take_along_dim(res.f, best[:, None], 1)[:, 0]
        return best_x, {"k": res.k, "n_evals": res.n_evals,
                        "rounds": res.rounds, "best_acq": best_acq}
