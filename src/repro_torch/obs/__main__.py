"""CLI: ``python -m repro_torch.obs <subcommand>`` — the flight-recorder
tools (counterpart of ``python -m repro.obs``).

Subcommands:

* ``timeline <journal_dir> [-o trace.json]`` — reconstruct a
  Chrome-trace/Perfetto timeline from a WAL journal (works on crashed
  runs with tracing off; the read never mutates the journal);
* ``validate <trace.json>`` — structural check that a trace file loads
  in Perfetto (the CI gate for exported artifacts);
* ``overhead [--n N] [--budget-ns NS]`` — microbenchmark the
  *disabled* tracer fast path of :mod:`repro_torch.obs.trace` (span +
  instant per iteration) and fail if it exceeds the per-call budget
  (default 5 µs), the enforceable proxy for "tracing off costs nothing
  measurable".

Exit status: 0 on success / valid / within budget, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_timeline(args) -> int:
    from repro_torch.obs import export

    trace = export.timeline_from_journal(args.journal_dir)
    errors = export.validate_chrome_trace(trace)
    if errors:
        for e in errors:
            print(f"error: {e}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(trace, f, indent=1)
    n = len(trace["traceEvents"])
    print(f"wrote {args.out} ({n} events from "
          f"{trace['otherData']['n_records']} journal records, "
          f"{trace['otherData']['truncated_bytes']} torn bytes)")
    return 0


def _cmd_validate(args) -> int:
    from repro_torch.obs import export

    with open(args.trace) as f:
        obj = json.load(f)
    errors = export.validate_chrome_trace(obj)
    if errors:
        for e in errors:
            print(f"{args.trace}: {e}", file=sys.stderr)
        return 1
    print(f"{args.trace}: OK ({len(obj['traceEvents'])} events)")
    return 0


def _cmd_overhead(args) -> int:
    from repro_torch.obs import trace

    trace.disable()                      # measure the off-by-default path
    n = args.n
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("bench"):
            pass
        trace.instant("bench")
    per_call_ns = 1e9 * (time.perf_counter() - t0) / (2 * n)
    ok = per_call_ns <= args.budget_ns
    print(f"disabled tracer: {per_call_ns:.0f} ns per span/instant call "
          f"(budget {args.budget_ns} ns) — {'OK' if ok else 'OVER BUDGET'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="flight-recorder tools: WAL timeline reconstruction, "
                    "Chrome-trace validation, overhead budget check")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("timeline",
                       help="reconstruct a Perfetto timeline from a WAL "
                            "journal directory")
    p.add_argument("journal_dir")
    p.add_argument("-o", "--out", default="timeline.json")
    p.set_defaults(fn=_cmd_timeline)

    p = sub.add_parser("validate",
                       help="structurally validate a Chrome-trace JSON "
                            "file")
    p.add_argument("trace")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("overhead",
                       help="microbench the disabled tracer fast path "
                            "against a per-call budget")
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--budget-ns", type=float, default=5000.0)
    p.set_defaults(fn=_cmd_overhead)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
