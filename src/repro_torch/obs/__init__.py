"""Telemetry plane: tracing, metrics, and flight-recorder export.

Three host-only modules threaded through every engine layer (EvalEngine
→ AskEngine → FleetEngine → FleetSampler → BOService):

* :mod:`repro_torch.obs.trace` — process-global span tracer (ring-buffered
  spans + instants, a no-op when disabled) and the ``ProgramTimer``
  wrapper that times device programs to a synchronize;
* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms with label
  attribution, Prometheus exposition, and the documented
  ``stats_snapshot()`` schema of this package (``validate_snapshot``);
* :mod:`repro_torch.obs.export` — Chrome-trace/Perfetto JSON from live
  traces, timeline reconstruction from WAL journals, and per-phase
  latency breakdowns.

All obs state is host-side and off by default; enabling it never adds a
program.  ``export`` is not imported here (it pulls in
``repro_torch.bo.journal``): import it explicitly (``from repro_torch.obs
import export``), so ``repro_torch.obs.trace`` stays importable from the
lowest engine layers without cycles.
"""
from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import (MetricsRegistry,  # noqa: F401
                                     SNAPSHOT_SCHEMAS, ingest_snapshot,
                                     validate_snapshot)
from repro_torch.obs.trace import (ProgramTimer, Tracer,  # noqa: F401
                                   disable, enable, enabled, get, instant,
                                   span)
