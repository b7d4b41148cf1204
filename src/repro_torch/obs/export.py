"""Exporters: Chrome-trace/Perfetto JSON from live traces or WAL journals
(counterpart of ``repro/obs/export.py``, host-only and copied).

Two sources feed the same format:

* **live** — :func:`chrome_trace` wraps a :class:`~repro_torch.obs.trace.
  Tracer`'s event ring (already Chrome-shaped) with the container dict
  and process/thread metadata Perfetto uses for track names;
* **post-mortem** — :func:`timeline_from_journal` reconstructs a
  timeline from any fleet or service WAL journal, tracing *off*: the
  journal's monotone ``seq`` becomes the time axis (1 ms per record — the
  WAL orders events, it does not timestamp them), fleet scheduler ops
  land on per-study tracks, service ops on per-tenant tracks, and each
  request's ``svc_ask → svc_done/svc_shed`` lifecycle becomes a span.
  Crashed runs replay through the journal's own torn-record truncation.
  The journal format is the reference's, so either package's function
  reads either package's journals and gives the same timeline.

:func:`validate_chrome_trace` is the structural contract both paths are
tested against (and what ``python -m repro_torch.obs validate`` runs);
:func:`phase_breakdown` turns span events into per-phase latency blocks.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Sequence

# pid values for reconstructed timelines (Perfetto shows them as
# separate process tracks); live traces use the real os.getpid()
FLEET_PID = 1
SVC_PID = 2

_SVC_OPS_TENANT_TRACK = ("svc_ask", "svc_reject", "svc_dispatch",
                         "svc_done", "svc_retry", "svc_shed",
                         "svc_degrade", "svc_shed_tenant")


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[Dict[str, Any]]:
    evs: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "ts": 0, "args": {"name": name}}]
    if tid is not None:
        evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "ts": 0, "args": {"name": tname}})
    return evs


def chrome_trace(events: Sequence[Mapping[str, Any]],
                 process_name: str = "repro",
                 meta: Optional[Mapping[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Wrap already Chrome-shaped events into a loadable trace object,
    adding process-name metadata for every pid seen."""
    evs: List[Dict[str, Any]] = []
    for pid in sorted({e.get("pid", 0) for e in events}):
        evs.extend(_meta(pid, process_name))
    evs.extend(dict(e) for e in events)
    out: Dict[str, Any] = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = dict(meta)
    return out


def write_chrome_trace(path: str, events: Sequence[Mapping[str, Any]],
                       process_name: str = "repro",
                       meta: Optional[Mapping[str, Any]] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, process_name, meta), f, indent=1)


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural validation of a Chrome-trace JSON object (the subset
    Perfetto's importer requires).  Returns error strings; empty means
    the trace loads."""
    errors: List[str] = []
    if not isinstance(obj, Mapping):
        return [f"top level is {type(obj).__name__}, expected object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, Mapping):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing string 'name'")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errors.append(f"{where}: missing phase 'ph'")
            continue
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errors.append(f"{where}: missing integer {k!r}")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"{where}: missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: 'X' event needs dur >= 0, "
                              f"got {dur!r}")
        if "args" in ev and not isinstance(ev["args"], Mapping):
            errors.append(f"{where}: 'args' is not an object")
        if len(errors) >= 50:
            errors.append("... (truncated)")
            break
    return errors


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def phase_breakdown(events: Sequence[Mapping[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """Per-span-name latency stats over 'X' events, for BENCH summary
    blocks: ``{name: {count, total_ms, p50_ms, p95_ms, p99_ms}}``."""
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_name.setdefault(ev["name"], []).append(
                float(ev.get("dur", 0.0)) / 1e3)
    out: Dict[str, Dict[str, float]] = {}
    for name, ms in sorted(by_name.items()):
        ms.sort()
        out[name] = {
            "count": len(ms),
            "total_ms": round(sum(ms), 3),
            "p50_ms": round(_quantile(ms, 0.50), 3),
            "p95_ms": round(_quantile(ms, 0.95), 3),
            "p99_ms": round(_quantile(ms, 0.99), 3),
        }
    return out


# --------------------------------------------------- WAL reconstruction

def _strip(rec: Mapping[str, Any], *drop: str) -> Dict[str, Any]:
    return {k: v for k, v in rec.items()
            if k not in drop and k != "seq" and k != "op"}


def timeline_from_journal(journal_dir: str) -> Dict[str, Any]:
    """Reconstruct a Chrome-trace timeline from a WAL journal directory.

    ``seq`` is the clock (1 ms per record).  Tracks: the fleet plane
    gets one thread per study plus a scheduler thread; the service
    plane one thread per tenant plus a controller thread.  Request
    lifecycles (``svc_ask`` .. ``svc_done``/``svc_shed``) render as
    complete spans on the owning tenant's track; everything else is an
    instant carrying the record's fields.
    """
    import os

    from repro_torch.bo.journal import JOURNAL_NAME, StudyJournal

    # pure read: never truncate or open-for-append a journal we are only
    # inspecting — a post-mortem must not alter the evidence
    path = os.path.join(journal_dir, JOURNAL_NAME)
    records, truncated_bytes = StudyJournal._scan_and_truncate(
        path, truncate=False)

    def ts(rec: Mapping[str, Any]) -> float:
        return 1e3 * float(rec.get("seq", 0))

    events: List[Dict[str, Any]] = []
    tenant_tids: Dict[str, int] = {}
    open_reqs: Dict[Any, Dict[str, Any]] = {}
    studies: set = set()
    last_ts = 0.0

    def tenant_tid(name: str) -> int:
        if name not in tenant_tids:
            tenant_tids[name] = len(tenant_tids) + 1
        return tenant_tids[name]

    for rec in records:
        op = rec.get("op", "?")
        t = ts(rec)
        last_ts = max(last_ts, t)
        if op.startswith("svc_"):
            pid = SVC_PID
            tenant = rec.get("tenant")
            rid = rec.get("req")
            if tenant is None and rid is not None and rid in open_reqs:
                tenant = open_reqs[rid]["tenant"]
            on_tenant_track = (op in _SVC_OPS_TENANT_TRACK
                               and tenant is not None)
            tid = tenant_tid(tenant) if on_tenant_track else 0
            if op == "svc_ask":
                open_reqs[rid] = {"tenant": tenant, "ts": t,
                                  "deadline": rec.get("deadline")}
            elif op in ("svc_done", "svc_shed") and rid in open_reqs:
                o = open_reqs.pop(rid)
                name = "request" if op == "svc_done" else \
                    f"request({rec.get('kind', 'shed')})"
                events.append({
                    "name": name, "ph": "X", "ts": o["ts"],
                    "dur": max(t - o["ts"], 1.0), "pid": pid, "tid": tid,
                    "args": {"req": rid, "tenant": tenant,
                             "deadline": o["deadline"]}})
            events.append({"name": op, "ph": "i", "ts": t, "s": "t",
                           "pid": pid, "tid": tid,
                           "args": _strip(rec, "x")})
        else:
            pid = FLEET_PID
            sid = rec.get("study", rec.get("sid"))
            tid = int(sid) + 1 if isinstance(sid, int) else 0
            if isinstance(sid, int):
                studies.add(sid)
            events.append({"name": op, "ph": "i", "ts": t, "s": "t",
                           "pid": pid, "tid": tid,
                           "args": _strip(rec, "x")})

    # requests still in flight at the end of the journal (crash /
    # truncation): draw them to the last seq so they are visible
    for rid, o in open_reqs.items():
        events.append({
            "name": "request(inflight)", "ph": "X", "ts": o["ts"],
            "dur": max(last_ts - o["ts"], 1.0), "pid": SVC_PID,
            "tid": tenant_tid(o["tenant"]) if o["tenant"] else 0,
            "args": {"req": rid, "tenant": o["tenant"], "open": True}})

    meta_evs: List[Dict[str, Any]] = []
    meta_evs.extend(_meta(FLEET_PID, "fleet plane", 0, "scheduler"))
    for sid in sorted(studies):
        meta_evs.extend(_meta(FLEET_PID, "fleet plane",
                              sid + 1, f"study {sid}")[1:])
    if any(e["pid"] == SVC_PID for e in events):
        meta_evs.extend(_meta(SVC_PID, "service plane", 0, "controller"))
        for name, tid in sorted(tenant_tids.items()):
            meta_evs.extend(_meta(SVC_PID, "service plane",
                                  tid, f"tenant {name}")[1:])

    return {"traceEvents": meta_evs + events, "displayTimeUnit": "ms",
            "otherData": {"source": "wal-journal",
                          "journal_dir": journal_dir,
                          "n_records": len(records),
                          "truncated_bytes": truncated_bytes}}
