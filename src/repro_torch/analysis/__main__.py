"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Exit status: 0 when every finding is fixed, inline-suppressed (with a
reason), or baselined (with a reason); 1 otherwise.  ``--check`` is the
CI entry point (identical semantics, kept explicit so workflows read
as intent).  Paths may be globs relative to the root.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import ALL_RULES, Baseline, Report, load_project, run_rules

# src/repro_torch/analysis/__main__.py → repo root is parents[3]
REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "examples/*_torch.py")
DEFAULT_BASELINE = "analysis_baseline_torch.json"


def _expand(root: Path, arg: str):
    p = Path(arg)
    if p.is_absolute():
        return [p]
    if any(c in arg for c in "*?["):
        return sorted(root.glob(arg))
    return [root / p]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant linter for the port's WAL and "
                    "compile-economy contracts")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs/globs to lint (default: "
                         f"{DEFAULT_PATHS} under the repo root)")
    ap.add_argument("--root", type=Path, default=REPO_ROOT,
                    help="repo root for relative paths in the report")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/"
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show every finding)")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the full JSON report here")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: exit 1 on any open finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="append all open findings to the baseline with "
                         "an empty reason (then edit in real reasons)")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    paths = [p for a in (args.paths or DEFAULT_PATHS)
             for p in _expand(root, a)]
    paths = [p for p in paths if p.exists()]
    if not paths:
        print("no input paths exist", file=sys.stderr)
        return 2

    # the tests/ exclusion guards the default sweep; a path the user
    # names explicitly (e.g. the lint fixtures) is always linted
    exclude = ("tests",) if not args.paths else ()
    project = load_project(paths, root, exclude=exclude)
    findings = run_rules(project, ALL_RULES)

    bpath = args.baseline or (root / DEFAULT_BASELINE)
    baseline = Baseline(path=bpath) if args.no_baseline \
        else Baseline.load(bpath)
    report = Report(project, findings, baseline)

    if args.update_baseline:
        for f in report.open:
            if f.rule == "baseline-missing-reason":
                continue
            baseline.entries.append(Baseline.entry_for(f, ""))
        baseline.save(bpath)
        print(f"wrote {len(report.open)} entries to {bpath}; "
              f"fill in the reasons (empty reasons fail the check)")
        return 0

    print(report.render())
    if args.json:
        report.write_json(args.json)
        print(f"\nJSON report: {args.json}")
    print(f"\nmodules={len(project.modules)} open={len(report.open)} "
          f"baselined={len(report.baselined)} "
          f"suppressed={len(report.suppressed)}")
    return 1 if report.failed else 0


if __name__ == "__main__":
    sys.exit(main())
