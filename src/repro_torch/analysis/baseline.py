"""Baseline (suppression) file: accepted findings with mandatory reasons.

Counterpart of ``repro/analysis/baseline.py``, unchanged; the port's
baseline is ``analysis_baseline_torch.json`` at the repo root.

The baseline is the triage record for pre-existing or by-design
findings: each entry pins one finding by its line-number-free identity
``(rule, file, func, snippet)`` and MUST carry a non-empty ``reason``.
A reasonless entry is itself reported as a finding — silencing without
saying why defeats the point of an invariant linter.

Matching is snippet-based (the stripped source line), so entries
survive unrelated edits that shift line numbers, and go stale (reported
as warnings) when the suppressed line itself changes or disappears.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import Finding, SEV_ERROR


class Baseline:
    def __init__(self, entries: Optional[List[dict]] = None,
                 path: Optional[Path] = None):
        self.path = path
        self.entries = entries or []
        self._index: Dict[Tuple[str, str, str, str], dict] = {}
        self._used: set = set()
        for e in self.entries:
            key = (e.get("rule", ""), e.get("file", ""),
                   e.get("func", ""), e.get("snippet", ""))
            self._index[key] = e

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls(path=path)
        data = json.loads(path.read_text())
        return cls(entries=data.get("entries", []), path=path)

    def save(self, path: Optional[Path] = None) -> None:
        p = path or self.path
        assert p is not None
        p.write_text(json.dumps(
            {"entries": sorted(self.entries,
                               key=lambda e: (e.get("rule", ""),
                                              e.get("file", ""),
                                              e.get("func", "")))},
            indent=2) + "\n")

    def match(self, finding: Finding) -> Optional[dict]:
        ent = self._index.get(finding.key())
        if ent is not None:
            self._used.add(finding.key())
        return ent

    def reasonless(self) -> List[Finding]:
        out = []
        for key, e in self._index.items():
            if not str(e.get("reason", "")).strip():
                out.append(Finding(
                    rule="baseline-missing-reason",
                    file=e.get("file", "?"), line=0, severity=SEV_ERROR,
                    message=(f"baseline entry for [{e.get('rule')}] in "
                             f"{e.get('func') or 'module'} has no reason; "
                             f"every suppression must say why"),
                    func=e.get("func", ""), snippet=e.get("snippet", "")))
        return out

    def stale(self) -> List[dict]:
        return [e for k, e in self._index.items() if k not in self._used]

    @staticmethod
    def entry_for(finding: Finding, reason: str) -> dict:
        return {"rule": finding.rule, "file": finding.file,
                "func": finding.func, "snippet": finding.snippet,
                "reason": reason}
