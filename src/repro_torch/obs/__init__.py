"""Host-side span tracer."""
