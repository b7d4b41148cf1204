"""Host-side span tracer (copied from ``repro/obs/trace.py``): span and
instant events, and :class:`ProgramTimer` for device programs.

One process-global :class:`Tracer` holds a bounded ring of finished
events in Chrome-trace form (``ph="X"`` complete spans with microsecond
``ts``/``dur``, ``ph="i"`` instants).  Instrumentation sites call the
module-level :func:`span` / :func:`instant` helpers, which are a single
``None``-check when tracing is off.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_CAPACITY = 65536


class Tracer:
    """Bounded, thread-safe ring of finished Chrome-trace events.

    Timestamps are microseconds relative to tracer creation
    (``perf_counter`` based).  When the ring is full the oldest events
    fall off (``n_dropped`` counts them).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.n_recorded = 0
        self.n_dropped = 0

    def now_us(self) -> float:
        return 1e6 * (time.perf_counter() - self._t0)

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.n_dropped += 1
            self._events.append(ev)
            self.n_recorded += 1

    def record_span(self, name: str, ts_us: float, dur_us: float,
                    **attrs: Any) -> None:
        ev: Dict[str, Any] = {
            "name": name, "ph": "X",
            "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
            "pid": os.getpid(), "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self._push(ev)

    def record_instant(self, name: str, **attrs: Any) -> None:
        ev: Dict[str, Any] = {
            "name": name, "ph": "i", "ts": round(self.now_us(), 3),
            "s": "t", "pid": os.getpid(), "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self._push(ev)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.n_recorded = 0
            self.n_dropped = 0


# The process-global tracer. ``None`` means disabled.
_TRACER: Optional[Tracer] = None


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _TRACER
    _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def get() -> Optional[Tracer]:
    return _TRACER


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[None]:
    """Time a host-side region as a complete ("X") event; no-op when
    tracing is disabled.  Attributes land in the event's ``args``."""
    tr = _TRACER
    if tr is None:
        yield
        return
    t0 = tr.now_us()
    try:
        yield
    finally:
        tr.record_span(name, t0, tr.now_us() - t0, **attrs)


def instant(name: str, **attrs: Any) -> None:
    """Record a point event ("i"); no-op when tracing is disabled."""
    tr = _TRACER
    if tr is not None:
        tr.record_instant(name, **attrs)


def _sync_devices() -> None:
    """Wait for the card (JAX's ``block_until_ready``); nothing when CUDA
    was never initialized in this process."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def synced_now_us() -> Optional[float]:
    """The tracer's clock once the card's queued work has finished (the
    rule :class:`ProgramTimer` times by); ``None``, with no
    synchronization, when tracing is off."""
    tr = _TRACER
    if tr is None:
        return None
    _sync_devices()
    return tr.now_us()


class ProgramTimer:
    """Wrap a ``CountingJit``-like program with device-completion timing.

    With the tracer enabled, each call records a span whose duration runs
    to ``torch.cuda.synchronize()`` after the call, and notes
    whether the call was a new program signature (``compiled``) via the
    wrapped counter.  Disabled: straight passthrough, no synchronization.
    Attribute access forwards to the inner program.
    """

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    def __call__(self, *args: Any, **kwargs: Any):
        tr = _TRACER
        if tr is None:
            return self._inner(*args, **kwargs)
        c0 = getattr(self._inner, "n_compiles", 0)
        t0 = tr.now_us()
        out = self._inner(*args, **kwargs)
        _sync_devices()
        tr.record_span(self._name, t0, tr.now_us() - t0,
                       compiled=getattr(self._inner, "n_compiles", 0) > c0)
        return out

    def __getattr__(self, name: str):
        return getattr(self._inner, name)
