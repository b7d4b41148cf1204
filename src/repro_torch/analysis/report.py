"""Run the rule set over a project and render JSON / human reports
(counterpart of ``repro/analysis/report.py``, unchanged)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

from .baseline import Baseline
from .core import Finding, Project, Rule


def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        for mod in project.modules:
            findings.extend(rule.run(mod, project))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


class Report:
    """Findings split into actionable / suppressed / baselined."""

    def __init__(self, project: Project, findings: List[Finding],
                 baseline: Baseline):
        self.open: List[Finding] = []          # must be fixed or triaged
        self.suppressed: List[dict] = []       # inline allows (with reason)
        self.baselined: List[dict] = []
        mods = {m.rel: m for m in project.modules}
        for f in findings:
            mod = mods.get(f.file)
            allow = mod.allow_for(f) if mod else None
            if allow is not None:
                if not allow[1]:
                    f.message += ("  [inline allow has no reason — "
                                  "suppression rejected]")
                    self.open.append(f)
                else:
                    self.suppressed.append({**f.to_json(),
                                            "reason": allow[1]})
                continue
            ent = baseline.match(f)
            if ent is not None:
                self.baselined.append({**f.to_json(),
                                       "reason": ent.get("reason", "")})
                continue
            self.open.append(f)
        # malformed baseline entries surface as findings too
        self.open.extend(baseline.reasonless())
        self.stale_baseline = baseline.stale()

    @property
    def failed(self) -> bool:
        return bool(self.open)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.open:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "open": [f.to_json() for f in self.open],
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "stale_baseline": self.stale_baseline,
            "counts": self.counts(),
            "n_open": len(self.open),
            "n_suppressed": len(self.suppressed),
            "n_baselined": len(self.baselined),
        }

    def write_json(self, path: Path) -> None:
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")

    def render(self) -> str:
        lines: List[str] = []
        if self.open:
            lines.append(f"{len(self.open)} open finding(s):")
            by_rule: Dict[str, List[Finding]] = {}
            for f in self.open:
                by_rule.setdefault(f.rule, []).append(f)
            for rule in sorted(by_rule):
                lines.append(f"\n[{rule}] ({len(by_rule[rule])})")
                for f in by_rule[rule]:
                    lines.append(f"  {f.file}:{f.line}: {f.message}"
                                 + (f"  (in {f.func})" if f.func else ""))
                    if f.snippet:
                        lines.append(f"      > {f.snippet}")
        else:
            lines.append("no open findings")
        if self.baselined:
            lines.append(f"\n{len(self.baselined)} baselined "
                         f"(accepted with reasons)")
        if self.suppressed:
            lines.append(f"{len(self.suppressed)} inline-suppressed")
        for e in self.stale_baseline:
            lines.append(f"stale baseline entry: [{e.get('rule')}] "
                         f"{e.get('file')} {e.get('func') or ''} — "
                         f"source line no longer matches; prune it")
        return "\n".join(lines)
