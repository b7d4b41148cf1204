"""Metrics registry + the unified ``stats_snapshot()`` schema contract
(counterpart of ``repro/obs/metrics.py``, host-only and copied).

Two halves:

* **Registry** — counters, gauges, and fixed-bucket histograms with
  label attribution (``study=...``, ``tenant=...``) and Prometheus text
  exposition, byte for byte the reference's.  All host state; nothing
  here touches torch.
* **Schemas** — the one documented layout for the four engine-layer
  ``stats_snapshot()`` dicts of this package (AskEngine, FleetEngine,
  FleetSampler, BOService) plus the EvalEngine block they compose over.
  The layers nest by dict union (FleetSampler = EvalEngine ∪ FleetEngine
  ∪ fleet extras; BOService = FleetSampler ∪ ``svc_*``), as the
  snapshots are built in code; :func:`validate_snapshot` checks an
  actual snapshot against the schema so the shapes cannot drift.  The
  port's snapshots carry four keys the reference's do not: EvalEngine's
  ``kernel_launches`` (CUDA launches by kernel) and FleetEngine's
  ``n_fit_evals``, ``n_mso_rounds`` and ``n_block_programs`` (what
  K1–K4's launch counts are held against).

:func:`ingest_snapshot` bridges the halves: it flattens any validated
snapshot into registry gauges (per-cause retrace counts, per-tenant
queue/served/shed series) so one Prometheus scrape exposes every layer.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, Any]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotone counter; one value series per label set."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + n

    def value(self, labels: Optional[Mapping[str, Any]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._values)


class Gauge(Counter):
    """Set-to-current-value metric (snapshot counters land here)."""

    kind = "gauge"

    def set(self, v: float,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + n


# default latency buckets (milliseconds): 0.1ms .. ~100s, roughly 2.5x
DEFAULT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 100000.0)


class Histogram:
    """Fixed-bucket histogram with quantile derivation.

    Buckets are cumulative upper bounds (Prometheus ``le`` semantics);
    observations above the last bound land in the implicit +Inf bucket.
    Quantiles interpolate linearly within the winning bucket, which is
    as precise as fixed buckets allow — good enough for p50/p95/p99
    summary blocks, not a substitute for the raw latency deques the
    service keeps for its SLO controller.
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS_MS):
        self.name = name
        self.help = help_
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {self.name}: no buckets")
        self._series: Dict[LabelKey, Dict[str, Any]] = {}

    def _cell(self, labels: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
        key = _label_key(labels)
        cell = self._series.get(key)
        if cell is None:
            cell = {"counts": [0] * (len(self.bounds) + 1),
                    "sum": 0.0, "count": 0}
            self._series[key] = cell
        return cell

    def observe(self, v: float,
                labels: Optional[Mapping[str, Any]] = None) -> None:
        v = float(v)
        cell = self._cell(labels)
        i = len(self.bounds)                     # +Inf bucket by default
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        cell["counts"][i] += 1
        cell["sum"] += v
        cell["count"] += 1

    def quantile(self, q: float,
                 labels: Optional[Mapping[str, Any]] = None
                 ) -> Optional[float]:
        cell = self._series.get(_label_key(labels))
        if cell is None or cell["count"] == 0:
            return None
        target = q * cell["count"]
        cum = 0
        for j, n in enumerate(cell["counts"]):
            if n == 0:
                continue
            if cum + n >= target:
                lo = 0.0 if j == 0 else self.bounds[j - 1]
                hi = self.bounds[j] if j < len(self.bounds) \
                    else self.bounds[-1]
                frac = (target - cum) / n
                return lo + frac * (hi - lo)
            cum += n
        return self.bounds[-1]

    def percentiles(self, labels: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50, labels),
                "p95": self.quantile(0.95, labels),
                "p99": self.quantile(0.99, labels)}

    def series(self) -> Dict[LabelKey, Dict[str, Any]]:
        return {k: dict(v) for k, v in self._series.items()}


class MetricsRegistry:
    """Named metric store with Prometheus text exposition."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help_, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS_MS
                  ) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format, metrics sorted by name."""
        out: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, cell in sorted(m.series().items()):
                    cum = 0
                    for j, b in enumerate(m.bounds):
                        cum += cell["counts"][j]
                        lk = _label_key(dict(key, le=f"{b:g}"))
                        out.append(f"{name}_bucket"
                                   f"{_render_labels(lk)} {cum}")
                    lk = _label_key(dict(key, le="+Inf"))
                    out.append(f"{name}_bucket{_render_labels(lk)} "
                               f"{cell['count']}")
                    out.append(f"{name}_sum{_render_labels(key)} "
                               f"{cell['sum']:g}")
                    out.append(f"{name}_count{_render_labels(key)} "
                               f"{cell['count']}")
            else:
                for key, v in sorted(m.series().items()):
                    out.append(f"{name}{_render_labels(key)} {v:g}")
        return "\n".join(out) + "\n"


# --------------------------------------------------------------- schemas
#
# The documented snapshot layout.  Each entry lists the exact top-level
# keys a layer's stats_snapshot() returns; composite layers are built by
# union, mirroring the dict-union construction in code.  ``optional``
# keys appear only in some configurations (journaled planes).

RETRACES_KEYS = frozenset({"causes", "by_program"})

EVAL_ENGINE_KEYS = frozenset({
    "n_compiles", "n_eval_compiles", "n_lockstep_compiles", "n_rounds",
    "n_points", "n_padded", "n_refit_fallbacks", "bucket_rounds",
    "kernel_launches", "retraces"})

ASK_ENGINE_KEYS = frozenset({
    "n_full_refits", "n_incremental", "n_fallbacks", "n_full_compiles",
    "n_incr_compiles", "n_ask_compiles", "retraces"})

FLEET_ENGINE_KEYS = frozenset({
    "n_studies", "n_blocks", "n_full_refits", "n_incremental",
    "n_fallbacks", "n_steps", "n_admissions", "n_migrations",
    "n_migrations_intra", "n_migrations_cross", "n_rejected", "n_shed",
    "n_quarantined", "n_parked", "n_retries", "n_retry_backoffs",
    "backoff_total_s", "n_devices", "slots_per_device", "queue_depth",
    "n_full_compiles", "n_incr_compiles", "n_mso_compiles",
    "n_fleet_compiles", "n_fit_evals", "n_mso_rounds", "n_block_programs",
    "retraces"})

FLEET_SAMPLER_KEYS = (EVAL_ENGINE_KEYS | FLEET_ENGINE_KEYS
                      | frozenset({"n_degraded"}))

SERVICE_KEYS = frozenset({
    "svc_rung", "svc_queue_depth", "svc_completed", "svc_shed",
    "svc_deadline_miss", "svc_rejected", "svc_retries",
    "svc_rung_changes", "svc_watchdog_alarms", "svc_p99_s",
    "svc_tenants"})

TENANT_KEYS = frozenset({
    "weight", "queue", "submitted", "served", "shed", "deadline_miss",
    "rejected", "bad_tells", "retries", "degraded", "is_shed"})

SNAPSHOT_SCHEMAS: Dict[str, Dict[str, frozenset]] = {
    "eval_engine": {"required": EVAL_ENGINE_KEYS,
                    "optional": frozenset()},
    "ask_engine": {"required": ASK_ENGINE_KEYS,
                   "optional": frozenset()},
    "fleet_engine": {"required": FLEET_ENGINE_KEYS,
                     "optional": frozenset()},
    # journal_seq appears iff the plane is journaled
    "fleet_sampler": {"required": FLEET_SAMPLER_KEYS,
                      "optional": frozenset({"journal_seq"})},
    "bo_service": {"required": FLEET_SAMPLER_KEYS | SERVICE_KEYS,
                   "optional": frozenset({"journal_seq"})},
}


def validate_snapshot(component: str, snap: Mapping[str, Any]
                      ) -> List[str]:
    """Structural check of a ``stats_snapshot()`` dict against the
    documented schema.  Returns a list of error strings (empty = valid):
    missing keys, unexpected keys, malformed ``retraces`` / tenant
    sub-blocks."""
    schema = SNAPSHOT_SCHEMAS.get(component)
    if schema is None:
        return [f"unknown component {component!r} "
                f"(know {sorted(SNAPSHOT_SCHEMAS)})"]
    errors: List[str] = []
    keys = set(snap.keys())
    missing = schema["required"] - keys
    extra = keys - schema["required"] - schema["optional"]
    if missing:
        errors.append(f"{component}: missing keys {sorted(missing)}")
    if extra:
        errors.append(f"{component}: unexpected keys {sorted(extra)}")
    rt = snap.get("retraces")
    if "retraces" in schema["required"] and isinstance(rt, Mapping):
        if set(rt.keys()) != RETRACES_KEYS:
            errors.append(f"{component}: retraces keys "
                          f"{sorted(rt.keys())} != {sorted(RETRACES_KEYS)}")
    elif "retraces" in schema["required"] and rt is not None:
        errors.append(f"{component}: retraces is {type(rt).__name__}, "
                      f"expected mapping")
    tenants = snap.get("svc_tenants")
    if "svc_tenants" in keys and isinstance(tenants, Mapping):
        for name, t in tenants.items():
            tk = set(t.keys())
            if tk != TENANT_KEYS:
                errors.append(
                    f"{component}: tenant {name!r} keys differ: "
                    f"missing {sorted(TENANT_KEYS - tk)}, "
                    f"extra {sorted(tk - TENANT_KEYS)}")
    return errors


def ingest_snapshot(registry: MetricsRegistry, component: str,
                    snap: Mapping[str, Any],
                    labels: Optional[Mapping[str, Any]] = None) -> None:
    """Flatten a (validated) snapshot into registry gauges.

    Scalar numeric keys become ``repro_<key>`` gauges labeled with
    ``component`` (+ caller labels, e.g. ``study=3``); retrace causes
    become a per-cause series; ``svc_tenants`` becomes per-tenant
    series for the numeric tenant fields.  Snapshots are cumulative, so
    re-ingesting simply overwrites — scrape-friendly.
    """
    base = dict(labels or {}, component=component)
    for key, v in snap.items():
        if isinstance(v, bool) or key == "svc_rung":
            continue
        if isinstance(v, (int, float)) and v is not None:
            registry.gauge(f"repro_{key}").set(v, labels=base)
    rt = snap.get("retraces")
    if isinstance(rt, Mapping):
        g = registry.gauge("repro_retraces",
                           "program traces by classified cause")
        for cause, n in rt.get("causes", {}).items():
            g.set(n, labels=dict(base, cause=cause))
    tenants = snap.get("svc_tenants")
    if isinstance(tenants, Mapping):
        for name, t in tenants.items():
            for key, v in t.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                registry.gauge(f"repro_tenant_{key}").set(
                    v, labels=dict(base, tenant=name))
    if isinstance(snap.get("svc_rung"), str):
        registry.gauge("repro_svc_rung_index",
                       "overload rung (0=admit .. 3=shed_tenant)").set(
            ["admit", "reject", "degrade",
             "shed_tenant"].index(snap["svc_rung"]), labels=base)
