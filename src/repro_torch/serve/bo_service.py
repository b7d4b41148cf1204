"""BO-as-a-service: an async multi-tenant ask/tell front end on the fleet
(counterpart of ``repro/serve/bo_service.py``: the same names, behaviour
and ``svc_*`` journal records, so either package's ``recover`` and
``timeline_from_journal`` read the other's journals).

The fleet plane (:class:`~repro_torch.bo.sampler.FleetSampler`) makes
batched suggests cheap, durable and crash-recoverable, but driven like a
benchmark it has one caller in synchronized rounds.  :class:`BOService`
is the service loop over it: a long-lived, single-threaded event loop
that turns fleet steps into a served workload for many *tenants* issuing
interleaved ask/tell calls at their own rates:

* **per-tenant fair queues** — ask requests queue per tenant and are
  dispatched under deficit-round-robin weighted fair scheduling
  (``TenantConfig.weight``): each scheduling round refills every active
  tenant's deficit by ``quantum x weight`` and serves requests (cost 1)
  while the deficit lasts, so one tenant's flood changes only its own
  queueing delay.  Tells are validated (non-finite refused — NaN-tell
  spam costs the spammer a synchronous ``ValueError`` and nobody else
  anything) and applied immediately.
* **per-request deadlines** — every ask carries a deadline budget
  (per-request override or the tenant default).  A request whose
  deadline passes while queued is shed before it costs a dispatch; one
  that comes back late is shed on completion (its trial stays pending,
  never told).  Either way the shed is journaled and the fleet-side slot
  reservation is cancelled (:meth:`FleetSampler.cancel_ask`).
* **bounded retry backoff** — a transient dispatch failure (an isolated
  per-study exception from the batch, or an injected dispatch veto)
  re-queues the request with bounded exponential backoff plus
  deterministic jitter (a fixed-seed host generator), up to
  ``max_retries`` attempts, each journaled.
* **overload ladder** — queue depth and a rolling p99 latency estimate
  drive a four-rung ladder, each transition journaled:
  ``admit`` → ``reject`` (new asks refused with
  :class:`~repro_torch.engine.fleet.FleetFullError` naming the reason) →
  ``degrade`` (the lowest-weight tenant's studies leave the fleet for
  the solo fused :class:`~repro_torch.engine.ask.AskEngine`, freeing
  slots but staying served) → ``shed_tenant`` (the lowest-weight tenant
  is dropped entirely, its queue failed with :class:`TenantShedError`).
* **watchdog + drain** — :meth:`install_watchdog` arms the SIGTERM
  flag; the loop polls it and drains at a request boundary: the pending
  queue is journaled (``svc_drain``), outstanding requests fail with
  :class:`ServiceDraining`, and :meth:`FleetSampler.drain` checkpoints
  and closes the journal.  Slow steps past ``watchdog_slow_step`` are
  journaled as ``svc_watchdog`` alarms.
* **recovery** — every service-visible transition (accept, dispatch,
  done, shed, retry, rung change, degrade, tenant shed, drain) is
  journaled *before* it takes effect, through the fleet's
  :class:`~repro_torch.bo.journal.StudyJournal`.  :meth:`BOService.recover`
  rebuilds the fleet via :meth:`FleetSampler.recover`, then replays the
  service records into a request ledger: requests that never dispatched
  re-enter their tenant queues in order; requests whose ask was
  journaled but never delivered come back as ready results.  At
  ``refit_interval=1`` the restored pending queue, and every suggestion
  it goes on to produce, is bitwise the uninterrupted run's.

Everything here is host-side scheduling over the same <= 3 fleet
programs per (bucket, slots) shape: no program keys on tenant, overload
rung, deadline, or recovery state.  Time comes from an injectable clock
(``now()``/``sleep()``), which the fleet's sleep hook shares, so the
whole control surface runs under a virtual clock in tests — deadlines,
backoff and watchdog behaviour are deterministic.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.bo.sampler import FleetSampler, Trial
from repro_torch.engine.fleet import FleetFullError
from repro_torch.obs import trace as obs

RUNGS = ("admit", "reject", "degrade", "shed_tenant")

# Per-tenant latency history cap: large enough that benchmark-scale runs
# keep every sample for exact p50/p99, bounded so a long-lived service
# deployment doesn't leak memory proportional to requests served.
TENANT_LATENCY_CAP = 65536


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget ran out (shed while queued, or the
    suggestion came back late); journaled as ``svc_shed``."""


class TenantShedError(RuntimeError):
    """The tenant was shed by the overload ladder (or never existed any
    more): its queued requests fail and new submissions are refused."""


class ServiceDraining(RuntimeError):
    """The service is draining (SIGTERM watchdog): outstanding requests
    fail but stay journaled, so recovery restores them."""


class RequestFailed(RuntimeError):
    """The request exhausted its transient-failure retry budget."""


@dataclass(frozen=True)
class TenantConfig:
    """One tenant: a named owner of fleet studies with a QoS contract."""
    name: str
    weight: float = 1.0              # DRR share (relative)
    studies: Tuple[int, ...] = ()    # FleetSampler study indices owned
    deadline: Optional[float] = None  # default per-ask budget (seconds)

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")


@dataclass(frozen=True)
class OverloadConfig:
    """Ladder thresholds.  Depth counts queued+delayed asks; the p99
    rungs compare the rolling completion-latency estimate to the SLO,
    and apply only while a backlog exists — the estimate refreshes on
    completions, so with an empty queue it is stale by construction and
    must not pin the service at reject."""
    reject_depth: int = 64           # rung 1: refuse new asks
    degrade_depth: int = 128         # rung 2: degrade lowest-weight tenant
    shed_depth: int = 256            # rung 3: shed lowest-weight tenant
    p99_slo: Optional[float] = None  # seconds; None disables p99 rungs
    tenant_queue_cap: Optional[int] = None   # per-tenant backlog cap
    window: int = 256                # latency samples in the p99 window
    min_samples: int = 20            # need this many before p99 counts


class _SystemClock:
    now = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


class _Request:
    """One ask request's lifecycle record (the sync-core 'future')."""

    __slots__ = ("rid", "tenant", "study", "submit_t", "deadline", "state",
                 "result", "error", "attempts", "not_before", "done_t",
                 "event")

    def __init__(self, rid: int, tenant: str, study: int, submit_t: float,
                 deadline: Optional[float]):
        self.rid = rid
        self.tenant = tenant
        self.study = study
        self.submit_t = submit_t
        self.deadline = deadline         # absolute service-clock time
        self.state = "queued"   # queued|delayed|dispatched|done|shed|failed
        self.result: Optional[Trial] = None
        self.error: Optional[BaseException] = None
        self.attempts = 0
        self.not_before: Optional[float] = None   # backoff eligibility
        self.done_t: Optional[float] = None
        self.event: Optional[asyncio.Event] = None   # async waiter, if any

    @property
    def done(self) -> bool:
        return self.state in ("done", "shed", "failed")

    def _wake(self) -> None:
        """Wake the async waiter (if one attached) after a terminal
        state transition.  Every code path that sets a terminal state
        must call this, or an :meth:`BOService.ask` coroutine waits
        forever."""
        if self.event is not None:
            self.event.set()


@dataclass
class _TenantState:
    cfg: TenantConfig
    queue: Deque[_Request] = field(default_factory=deque)
    deficit: float = 0.0
    shed: Optional[str] = None       # ladder rung 3 reason
    degraded: Optional[str] = None   # ladder rung 2 reason
    # per-tenant service stats (all service-visible QoS accounting)
    n_submitted: int = 0
    n_served: int = 0
    n_shed: int = 0
    n_deadline_miss: int = 0
    n_rejected: int = 0
    n_bad_tells: int = 0
    n_retries: int = 0
    latencies: Deque[float] = field(
        default_factory=lambda: deque(maxlen=TENANT_LATENCY_CAP))


class BOService:
    """Single-threaded async ask/tell service loop over a FleetSampler.

    The sync core (`submit_ask` / `submit_tell` / `service_step`) is the
    whole state machine — tests and benchmarks drive it directly, under
    a virtual clock when determinism matters.  The async facade
    (:meth:`ask` / :meth:`tell` / :meth:`run`) wraps it for coroutine
    clients sharing one event loop with the server task.

    Every study index in ``fs`` must be owned by exactly one tenant.
    Journaling (and therefore :meth:`recover`) requires the sampler to
    have been built with ``journal_dir``.
    """

    def __init__(self, fs: FleetSampler, tenants: List[TenantConfig], *,
                 overload: Optional[OverloadConfig] = None,
                 quantum: float = 1.0,
                 max_batch: Optional[int] = None,
                 max_retries: int = 3,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 1.0,
                 backoff_jitter: float = 0.25,
                 watchdog_slow_step: Optional[float] = None,
                 clock=None, _recovering: bool = False):
        self.fs = fs
        self.overload = overload if overload is not None else OverloadConfig()
        self.quantum = float(quantum)
        self.max_batch = max_batch
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.backoff_jitter = float(backoff_jitter)
        self.watchdog_slow_step = watchdog_slow_step
        self.clock = clock if clock is not None else _SystemClock()
        if clock is not None:
            # one time base: fleet-side backoff/latency sleeps charge the
            # same (possibly virtual) clock the service schedules on
            fs.fleet._sleep = self.clock.sleep
        self._backoff_rng = np.random.default_rng(0x5E)
        self._tenants: Dict[str, _TenantState] = {}
        self._order: List[str] = []
        self._study_owner: Dict[int, str] = {}
        for tc in tenants:
            if tc.name in self._tenants:
                raise ValueError(f"duplicate tenant {tc.name!r}")
            for s in tc.studies:
                if not 0 <= s < len(fs):
                    raise ValueError(
                        f"tenant {tc.name!r}: study {s} out of range "
                        f"(fleet has {len(fs)})")
                if s in self._study_owner:
                    raise ValueError(
                        f"study {s} owned by both "
                        f"{self._study_owner[s]!r} and {tc.name!r}")
                self._study_owner[s] = tc.name
            self._tenants[tc.name] = _TenantState(cfg=tc)
            self._order.append(tc.name)
        self._delayed: List[_Request] = []   # backoff'd, awaiting retry
        self._req_seq = 0
        self._rung = 0
        self._rung_reason = ""
        self._lat: Deque[float] = deque(maxlen=self.overload.window)
        self._draining = False
        self._stopped = False
        self._preempt = None
        # service counters (rolled into stats_snapshot)
        self.n_completed = 0
        self.n_shed = 0
        self.n_deadline_miss = 0
        self.n_rejected = 0
        self.n_retries = 0
        self.n_rung_changes = 0
        self.n_watchdog_alarms = 0
        self.recovered: Dict[str, List[_Request]] = {"ready": [],
                                                     "queued": []}
        if not _recovering:
            self._journal({"op": "svc_config",
                           "tenants": [dict(name=t.name, weight=t.weight,
                                            studies=list(t.studies),
                                            deadline=t.deadline)
                                       for t in tenants],
                           "overload": dict(
                               reject_depth=self.overload.reject_depth,
                               degrade_depth=self.overload.degrade_depth,
                               shed_depth=self.overload.shed_depth,
                               p99_slo=self.overload.p99_slo,
                               tenant_queue_cap=(
                                   self.overload.tenant_queue_cap),
                               window=self.overload.window,
                               min_samples=self.overload.min_samples),
                           "quantum": self.quantum,
                           "max_batch": self.max_batch,
                           "max_retries": self.max_retries,
                           "backoff_base": self.backoff_base,
                           "backoff_cap": self.backoff_cap,
                           "backoff_jitter": self.backoff_jitter})

    # ------------------------------------------------------------ plumbing
    def _journal(self, rec: dict) -> None:
        self.fs._append(rec)

    def _now(self) -> float:
        return self.clock.now()

    def p99(self) -> Optional[float]:
        if len(self._lat) < self.overload.min_samples:
            return None
        return float(np.quantile(np.asarray(self._lat), 0.99))

    def queue_depth(self) -> int:
        return (sum(len(t.queue) for t in self._tenants.values())
                + len(self._delayed))

    # ---------------------------------------------------------- submission
    def submit_ask(self, tenant: str, study: Optional[int] = None,
                   deadline: Optional[float] = None) -> _Request:
        """Accept (or refuse) one ask.  Returns the request handle the
        caller polls (``req.done`` / ``req.result`` / ``req.error``).
        Refusals raise: :class:`TenantShedError`, :class:`FleetFullError`
        (overload rung >= reject, or per-tenant backlog cap), or
        :class:`ServiceDraining`."""
        t = self._tenants[tenant]
        if t.shed is not None:
            raise TenantShedError(f"tenant {tenant!r} shed: {t.shed}")
        if self._draining or self._stopped:
            raise ServiceDraining("service is draining")
        if study is None:
            if len(t.cfg.studies) != 1:
                raise ValueError(f"tenant {tenant!r} owns "
                                 f"{len(t.cfg.studies)} studies; pass "
                                 f"study= explicitly")
            study = t.cfg.studies[0]
        if self._study_owner.get(study) != tenant:
            raise ValueError(f"study {study} is not owned by {tenant!r}")
        now = self._now()
        rid = self._req_seq
        cap = self.overload.tenant_queue_cap
        reason = None
        if self._rung >= 1:
            reason = (f"service overloaded (rung "
                      f"{RUNGS[self._rung]}): {self._rung_reason}")
        elif cap is not None and len(t.queue) >= cap:
            reason = (f"tenant {tenant!r} backlog {len(t.queue)} at cap "
                      f"(tenant_queue_cap={cap})")
        if reason is not None:
            self._req_seq += 1
            t.n_rejected += 1
            self.n_rejected += 1
            self._journal({"op": "svc_reject", "req": rid,
                           "tenant": tenant, "reason": reason})
            raise FleetFullError(reason)
        budget = deadline if deadline is not None else t.cfg.deadline
        dl = None if budget is None else now + float(budget)
        # WAL: the accepted request is durable before it is queued
        self._journal({"op": "svc_ask", "req": rid, "tenant": tenant,
                       "study": study, "t": now, "deadline": dl})
        self._req_seq += 1
        req = _Request(rid, tenant, study, now, dl)
        t.queue.append(req)
        t.n_submitted += 1
        return req

    def submit_tell(self, tenant: str, study: int, trial_id: int, y: float,
                    *, failed: bool = False,
                    error: Optional[str] = None) -> None:
        """Validate and apply one tell immediately (tells are O(1) host
        appends; the WAL record is the fleet's own ``tell`` op).  A
        non-finite ``y`` raises before anything is journaled — NaN-tell
        spam never enters the WAL, the GP, or anyone else's schedule."""
        t = self._tenants[tenant]
        if t.shed is not None:
            raise TenantShedError(f"tenant {tenant!r} shed: {t.shed}")
        if self._study_owner.get(study) != tenant:
            raise ValueError(f"study {study} is not owned by {tenant!r}")
        try:
            self.fs.tell(study, trial_id, y, failed=failed, error=error)
        except ValueError:
            t.n_bad_tells += 1
            raise

    # ------------------------------------------------------ the event loop
    def service_step(self) -> int:
        """One scheduling round: watchdog → backoff releases → deadline
        sheds → overload ladder → DRR dispatch → ONE fleet step →
        resolve.  Returns the number of asks that completed."""
        if self._preempt is not None and self._preempt.triggered \
                and not self._draining:
            self.drain()
            return 0
        if self._draining or self._stopped:
            return 0
        now = self._now()
        self._release_delayed(now)
        self._expire_deadlines(now)
        self._update_rung(now)
        with obs.span("svc.drr_round", rung=RUNGS[self._rung]):
            batch = self._drr_schedule(now)
        if not batch:
            return 0
        t0 = now
        with obs.span("svc.dispatch", n=len(batch)):
            served = self._dispatch(batch)
        wall = self._now() - t0
        if (self.watchdog_slow_step is not None
                and wall > self.watchdog_slow_step):
            self.n_watchdog_alarms += 1
            self._journal({"op": "svc_watchdog", "step_wall_s": wall,
                           "batch": [r.rid for r in batch]})
        return served

    def _release_delayed(self, now: float) -> None:
        """Move backoff'd requests whose eligibility time arrived back to
        the head of their tenant queue (rid order preserved)."""
        ready = [r for r in self._delayed if r.not_before <= now]
        if not ready:
            return
        self._delayed = [r for r in self._delayed
                         if r.not_before > now]
        for req in sorted(ready, key=lambda r: -r.rid):
            req.state = "queued"
            self._tenants[req.tenant].queue.appendleft(req)

    def _expire_deadlines(self, now: float) -> None:
        for t in self._tenants.values():
            keep: Deque[_Request] = deque()
            for req in t.queue:
                if req.deadline is not None and now > req.deadline:
                    self._shed_request(req, "deadline exceeded while "
                                       "queued", now)
                else:
                    keep.append(req)
            t.queue = keep
        still = []
        for req in self._delayed:
            if req.deadline is not None and now > req.deadline:
                self._shed_request(req, "deadline exceeded in backoff",
                                   now)
            else:
                still.append(req)
        self._delayed = still

    def _shed_request(self, req: _Request, reason: str,
                      now: float) -> None:
        """WAL, then fail the request; a request that ever dispatched
        also withdraws its fleet-side reservation."""
        self._journal({"op": "svc_shed", "req": req.rid,
                       "kind": "deadline", "reason": reason})
        obs.instant("svc.shed", req=req.rid, tenant=req.tenant,
                    kind="deadline", reason=reason)
        if req.attempts > 0 or req.state == "dispatched":
            self.fs.cancel_ask(req.study)
        req.state = "shed"
        req.error = DeadlineExceeded(
            f"request {req.rid} ({req.tenant!r}/study {req.study}): "
            f"{reason}")
        req.done_t = now
        t = self._tenants[req.tenant]
        t.n_shed += 1
        t.n_deadline_miss += 1
        self.n_shed += 1
        self.n_deadline_miss += 1
        req._wake()

    # ------------------------------------------------------ overload ladder
    def _update_rung(self, now: float) -> None:
        oc = self.overload
        depth = self.queue_depth()
        # The p99 estimate only refreshes on completions.  With an empty
        # queue there are no completions coming (rung >= 1 refuses new
        # asks), so a stale over-SLO window would otherwise freeze the
        # service in reject forever; p99 rungs apply only while a
        # backlog exists to refresh the estimate.
        p99 = self.p99() if depth > 0 else None
        rung, why = 0, ""
        checks = [(1, oc.reject_depth, 1.0), (2, oc.degrade_depth, 2.0),
                  (3, oc.shed_depth, 4.0)]
        for level, dth, slo_mult in checks:
            if depth >= dth:
                rung, why = level, f"queue depth {depth} >= {dth}"
            elif (oc.p99_slo is not None and p99 is not None
                    and p99 >= slo_mult * oc.p99_slo):
                rung, why = level, (f"p99 {p99:.3f}s >= "
                                    f"{slo_mult:g}x SLO {oc.p99_slo}s")
        if rung == self._rung:
            return
        prev = self._rung
        self._journal({"op": "svc_overload", "rung": RUNGS[rung],
                       "from": RUNGS[prev], "depth": depth, "p99": p99,
                       "reason": why})
        obs.instant("svc.rung_change", rung=RUNGS[rung],
                    from_rung=RUNGS[prev], depth=depth, reason=why)
        self._rung, self._rung_reason = rung, why
        self.n_rung_changes += 1
        if rung >= 2 and prev < 2:
            self._degrade_lowest_weight(why)
        if rung >= 3 and prev < 3:
            self._shed_lowest_weight(why, now)

    def _victim(self, *, skip_degraded: bool) -> Optional[_TenantState]:
        cands = [t for t in self._tenants.values() if t.shed is None
                 and not (skip_degraded and t.degraded is not None)]
        if len(cands) <= 1:
            return None              # never degrade/shed the only tenant
        return min(cands, key=lambda t: (t.cfg.weight, t.cfg.name))

    def _degrade_lowest_weight(self, why: str) -> None:
        """Ladder rung 2: move the lowest-weight tenant's studies off the
        shared fleet plane onto the solo AskEngine path — capacity for
        everyone else, continued (slower) service for the victim."""
        t = self._victim(skip_degraded=True)
        if t is None:
            return
        reason = f"service overload degrade: {why}"
        self._journal({"op": "svc_degrade", "tenant": t.cfg.name,
                       "studies": list(t.cfg.studies), "reason": reason})
        obs.instant("svc.degrade", tenant=t.cfg.name, reason=reason)
        t.degraded = reason
        for study in t.cfg.studies:
            s = self.fs.samplers[study]
            if s._fleet is not None:
                sid = s._fleet_sid
                self.fs.fleet.shed_study(sid, reason)
                s._detach_fleet(reason)

    def _shed_lowest_weight(self, why: str, now: float) -> None:
        """Ladder rung 3: drop the lowest-weight tenant entirely."""
        t = self._victim(skip_degraded=False)
        if t is None:
            return
        reason = f"service overload shed: {why}"
        dropped = [r.rid for r in t.queue] + \
                  [r.rid for r in self._delayed if r.tenant == t.cfg.name]
        self._journal({"op": "svc_shed_tenant", "tenant": t.cfg.name,
                       "reason": reason, "dropped": dropped})
        obs.instant("svc.shed_tenant", tenant=t.cfg.name,
                    n_dropped=len(dropped), reason=reason)
        t.shed = reason
        mine = list(t.queue) + [r for r in self._delayed
                                if r.tenant == t.cfg.name]
        t.queue.clear()
        self._delayed = [r for r in self._delayed
                         if r.tenant != t.cfg.name]
        for req in mine:         # queued AND backoff-delayed both resolve
            req.state = "shed"
            req.error = TenantShedError(reason)
            req.done_t = now
            t.n_shed += 1
            self.n_shed += 1
            req._wake()
        for study in t.cfg.studies:
            s = self.fs.samplers[study]
            if s._fleet is not None:
                sid = s._fleet_sid
                self.fs.fleet.shed_study(sid, reason)
                s._detach_fleet(reason)

    # --------------------------------------------------------- scheduling
    def _drr_schedule(self, now: float) -> List[_Request]:
        """Deficit round robin over tenant queues: refill each active
        tenant's deficit by quantum x weight, serve head requests at unit
        cost while it lasts.  At most one in-flight ask per study per
        round (a study's suggest is a single slot reservation)."""
        batch: List[_Request] = []
        seen_studies = set()
        for name in self._order:
            t = self._tenants[name]
            if t.shed is not None or not t.queue:
                continue
            t.deficit += self.quantum * t.cfg.weight
            while t.queue and t.deficit >= 1.0:
                if self.max_batch is not None \
                        and len(batch) >= self.max_batch:
                    break
                head = t.queue[0]
                if head.study in seen_studies:
                    break            # one reservation per study per round
                t.queue.popleft()
                t.deficit -= 1.0
                head.state = "dispatched"
                batch.append(head)
                seen_studies.add(head.study)
            if not t.queue:
                t.deficit = 0.0      # classic DRR: empty queue resets
        return batch

    def _dispatch(self, batch: List[_Request]) -> int:
        """Journal dispatches, run ONE batched fleet trial boundary for
        the scheduled studies, resolve results/retries/late sheds."""
        fi = self.fs.fault_injector
        live: List[_Request] = []
        for req in batch:
            self._journal({"op": "svc_dispatch", "req": req.rid,
                           "study": req.study})
            req.attempts += 1
            if fi is not None and hasattr(fi, "ask_ok") \
                    and not fi.ask_ok(req.study):
                self._retry(req, RuntimeError(
                    f"injected transient dispatch failure "
                    f"(study {req.study})"))
                continue
            live.append(req)
        if not live:
            return 0
        trials = self.fs.ask_batch([r.study for r in live])
        t1 = self._now()
        served = 0
        for req, trial in zip(live, trials):
            if isinstance(trial, Exception):
                self._retry(req, trial)
                continue
            if req.deadline is not None and t1 > req.deadline:
                # came back late: cancel-and-shed (the pending trial is
                # simply never told; recovery lists it as re-evaluable)
                self._shed_request(req, "deadline exceeded in flight", t1)
                continue
            self._journal({"op": "svc_done", "req": req.rid,
                           "trial": trial.trial_id})
            req.result = trial
            req.state = "done"
            req.done_t = t1
            lat = t1 - req.submit_t
            self._lat.append(lat)
            t = self._tenants[req.tenant]
            t.n_served += 1
            t.latencies.append(lat)
            self.n_completed += 1
            served += 1
            req._wake()
        return served

    def _retry(self, req: _Request, err: BaseException) -> None:
        """Transient failure: bounded exponential backoff with jitter,
        then back into the tenant queue; exhaustion fails the request."""
        t = self._tenants[req.tenant]
        if req.attempts > self.max_retries:
            self._journal({"op": "svc_shed", "req": req.rid,
                           "kind": "failed",
                           "reason": f"retries exhausted: {err}"})
            obs.instant("svc.shed", req=req.rid, tenant=req.tenant,
                        kind="failed")
            req.state = "failed"
            req.error = RequestFailed(
                f"request {req.rid}: {req.attempts} attempts failed; "
                f"last: {err}")
            req.done_t = self._now()
            t.n_shed += 1
            self.n_shed += 1
            req._wake()
            return
        delay = min(self.backoff_base * (2.0 ** (req.attempts - 1)),
                    self.backoff_cap)
        delay *= 1.0 + self.backoff_jitter * float(
            self._backoff_rng.random())
        not_before = self._now() + delay
        self._journal({"op": "svc_retry", "req": req.rid,
                       "attempt": req.attempts, "delay_s": delay,
                       "not_before": not_before, "error": str(err)})
        obs.instant("svc.retry", req=req.rid, tenant=req.tenant,
                    attempt=req.attempts, delay_s=delay)
        req.not_before = not_before
        req.state = "delayed"
        self._delayed.append(req)
        t.n_retries += 1
        self.n_retries += 1

    # ------------------------------------------------------ watchdog/drain
    def install_watchdog(self):
        """Arm SIGTERM/SIGUSR1 → drain-at-request-boundary (the fleet's
        preemption flag); returns the flag for external pollers."""
        self._preempt = self.fs.install_drain_handler()
        return self._preempt

    def drain(self) -> dict:
        """Graceful shutdown: journal the pending queue (it survives to
        recovery — in-flight requests are journaled before any state
        changes), fail outstanding futures with ServiceDraining, then
        checkpoint + close through :meth:`FleetSampler.drain`."""
        queued = [r.rid for t in self._tenants.values() for r in t.queue]
        queued += [r.rid for r in self._delayed]
        self._journal({"op": "svc_drain", "queued": sorted(queued)})
        obs.instant("svc.drain", n_queued=len(queued))
        self._draining = True
        now = self._now()
        for t in self._tenants.values():
            for req in t.queue:
                req.state = "shed"
                req.error = ServiceDraining(
                    f"request {req.rid} interrupted by drain (journaled; "
                    f"recovery restores it)")
                req.done_t = now
                req._wake()
            t.queue.clear()
        for req in self._delayed:
            req.state = "shed"
            req.error = ServiceDraining(
                f"request {req.rid} interrupted by drain (journaled; "
                f"recovery restores it)")
            req.done_t = now
            req._wake()
        self._delayed = []
        return self.fs.drain()

    def stop(self) -> None:
        self._stopped = True

    # ------------------------------------------------------------ recovery
    @classmethod
    def recover(cls, journal_dir: str, *, device=None, mesh=None,
                fault_injector=None, clock=None
                ) -> Tuple["BOService", "object"]:
        """Rebuild a crashed/drained service from its journal directory
        (this package's or the reference's).

        Fleet state recovers through :meth:`FleetSampler.recover` on
        ``device`` (``None``: the card; the normal paths — bitwise at
        ``refit_interval=1``).  The service
        ledger then replays the ``svc_*`` records: every accepted ask
        that never resolved is restored — never-dispatched (or
        dispatched-but-never-asked) requests re-enter their tenant
        queues in rid order and recompute the identical suggestion
        (same key, same observations); requests whose ask WAS journaled
        but never delivered come back pre-resolved in
        ``service.recovered["ready"]`` for the driver to collect.
        Returns ``(service, RecoveryReport)``."""
        if mesh is not None:
            raise NotImplementedError(
                "a fleet across several cards (mesh=) is not ported yet: "
                "ROADMAP queue A item 9b")
        sleep_fn = None if clock is None else clock.sleep
        fs, rep = FleetSampler.recover(journal_dir, device=device,
                                       fault_injector=fault_injector,
                                       sleep_fn=sleep_fn)
        records = fs.journal.replay()
        svc_cfg = next((r for r in records if r.get("op") == "svc_config"),
                       None)
        if svc_cfg is None:
            raise ValueError(f"journal at {journal_dir!r} has no "
                             f"svc_config record — not a BOService "
                             f"journal")
        tenants = [TenantConfig(name=t["name"], weight=t["weight"],
                                studies=tuple(t["studies"]),
                                deadline=t["deadline"])
                   for t in svc_cfg["tenants"]]
        svc = cls(fs, tenants, overload=OverloadConfig(**svc_cfg[
                      "overload"]),
                  quantum=svc_cfg["quantum"],
                  max_batch=svc_cfg["max_batch"],
                  max_retries=svc_cfg["max_retries"],
                  backoff_base=svc_cfg["backoff_base"],
                  backoff_cap=svc_cfg["backoff_cap"],
                  backoff_jitter=svc_cfg["backoff_jitter"],
                  clock=clock, _recovering=True)
        # ---- replay the request ledger
        ledger: Dict[int, _Request] = {}
        dispatched: Dict[int, int] = {}   # study -> rid awaiting its ask
        max_rid = -1
        for rec in records:
            op = rec.get("op")
            if op == "svc_ask":
                rid = rec["req"]
                max_rid = max(max_rid, rid)
                ledger[rid] = _Request(rid, rec["tenant"], rec["study"],
                                       rec["t"], rec["deadline"])
            elif op == "svc_reject":
                max_rid = max(max_rid, rec["req"])
            elif op == "svc_dispatch":
                req = ledger.get(rec["req"])
                if req is not None and not req.done:
                    req.attempts += 1
                    dispatched[req.study] = req.rid
            elif op == "ask":
                rid = dispatched.pop(rec["study"], None)
                if rid is not None and not ledger[rid].done:
                    # the suggest was journaled: deliver it on restart
                    ledger[rid].result = fs.samplers[
                        rec["study"]].trials[rec["trial"]]
                    ledger[rid].state = "done"
            elif op == "svc_done":
                req = ledger.get(rec["req"])
                if req is not None:
                    req.state = "done"
                    req.done_t = -1.0        # delivered before the crash
                    req.result = fs.samplers[req.study].trials[
                        rec["trial"]]
                    dispatched.pop(req.study, None)
            elif op == "svc_retry":
                req = ledger.get(rec["req"])
                if req is not None:
                    req.state = "queued"     # backoff restarts fresh
                    dispatched.pop(req.study, None)
            elif op == "svc_shed":
                req = ledger.get(rec["req"])
                if req is not None:
                    # two shed kinds share the record: deadline sheds
                    # and retries-exhausted failures keep their live
                    # error class through replay (older journals lack
                    # the field — fall back on the reason text)
                    kind = rec.get("kind")
                    if kind is None:
                        kind = ("failed" if rec["reason"].startswith(
                            "retries exhausted") else "deadline")
                    if kind == "failed":
                        req.state = "failed"
                        req.error = RequestFailed(rec["reason"])
                    else:
                        req.state = "shed"
                        req.error = DeadlineExceeded(rec["reason"])
                    dispatched.pop(req.study, None)
            elif op == "svc_overload":
                svc._rung = RUNGS.index(rec["rung"])
                svc._rung_reason = rec.get("reason", "")
            elif op == "svc_degrade":
                t = svc._tenants.get(rec["tenant"])
                if t is not None:
                    t.degraded = rec["reason"]
            elif op == "svc_shed_tenant":
                t = svc._tenants.get(rec["tenant"])
                if t is not None:
                    t.shed = rec["reason"]
                for rid in rec.get("dropped", ()):
                    if rid in ledger:
                        ledger[rid].state = "shed"
                        ledger[rid].error = TenantShedError(rec["reason"])
            # svc_drain / svc_watchdog / fleet ops: informational here
        svc._req_seq = max_rid + 1
        # ---- restore the pending queue (rid order == submission order)
        for rid in sorted(ledger):
            req = ledger[rid]
            t = svc._tenants[req.tenant]
            if req.state == "done" and req.done_t is None:
                # asked-but-undelivered: ready result for the driver
                svc.recovered["ready"].append(req)
            elif not req.done and t.shed is None:
                req.state = "queued"
                req.attempts = 0
                t.queue.append(req)
                svc.recovered["queued"].append(req)
        return svc, rep

    # ---------------------------------------------------------- observers
    def stats_snapshot(self) -> dict:
        snap = self.fs.stats_snapshot()
        p99 = self.p99()
        snap.update({
            "svc_rung": RUNGS[self._rung],
            "svc_queue_depth": self.queue_depth(),
            "svc_completed": self.n_completed,
            "svc_shed": self.n_shed,
            "svc_deadline_miss": self.n_deadline_miss,
            "svc_rejected": self.n_rejected,
            "svc_retries": self.n_retries,
            "svc_rung_changes": self.n_rung_changes,
            "svc_watchdog_alarms": self.n_watchdog_alarms,
            "svc_p99_s": p99,
            "svc_tenants": {
                name: dict(weight=t.cfg.weight,
                           queue=len(t.queue),
                           submitted=t.n_submitted, served=t.n_served,
                           shed=t.n_shed,
                           deadline_miss=t.n_deadline_miss,
                           rejected=t.n_rejected,
                           bad_tells=t.n_bad_tells, retries=t.n_retries,
                           degraded=t.degraded is not None,
                           is_shed=t.shed is not None)
                for name, t in self._tenants.items()},
        })
        return snap

    def tenant_latencies(self, tenant: str) -> List[float]:
        return list(self._tenants[tenant].latencies)

    # -------------------------------------------------------- async facade
    async def ask(self, tenant: str, study: Optional[int] = None,
                  deadline: Optional[float] = None) -> Trial:
        req = self.submit_ask(tenant, study, deadline)
        if not req.done:
            # event-wait, not a sleep(0) poll loop: the waiting client
            # coroutine parks until the server task resolves the
            # request (every terminal transition calls req._wake()),
            # so idle waiters cost the event loop nothing
            req.event = asyncio.Event()
            if req.done:     # resolved between submit and attach
                req.event.set()
            await req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    async def tell(self, tenant: str, study: int, trial_id: int, y: float,
                   *, failed: bool = False,
                   error: Optional[str] = None) -> None:
        self.submit_tell(tenant, study, trial_id, y, failed=failed,
                         error=error)
        await asyncio.sleep(0)

    async def run(self, *, idle_sleep: float = 0.001) -> None:
        """The server task: drive the loop until :meth:`stop` or drain.
        Runs the (synchronous) fleet step inline — single-threaded by
        design — and yields to client coroutines between rounds."""
        while not self._stopped and not self._draining:
            n = self.service_step()
            await asyncio.sleep(0 if n else idle_sleep)
