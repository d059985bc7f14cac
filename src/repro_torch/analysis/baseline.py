"""Baseline (frozen-debt) bookkeeping for the lint pass.

``src/repro_torch/analysis/baseline.json`` pins the violations that
existed when a rule landed; the lint gate fails only on findings NOT in
the baseline, so new rules can ship strict without a flag-day cleanup.
The format (version 1) is the JAX package's, so either package's
baseline file loads in the other's ``load``.  Matching is by
``(file, code, message)`` with multiplicity — line numbers are recorded
for humans but ignored, so pure line drift does not churn the file.

Workflow:

* ``python -m repro_torch.analysis.lint --baseline
  src/repro_torch/analysis/baseline.json``
  — gate mode: exit 1 on any non-baselined finding.
* ``... --write-baseline`` — refreeze: rewrite the baseline to exactly
  the current findings (do this only after reviewing each one; fixing
  beats freezing).
* stale entries (baselined violations that no longer occur) are
  reported as notes — prune them with ``--write-baseline`` so the debt
  ledger only ever shrinks.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis.checkers import Violation

FORMAT_VERSION = 1

Key = Tuple[str, str, str]


def load(path: Path) -> Counter:
    """Baseline file → multiset of suppression keys.  A missing file is
    an empty baseline (everything is new)."""
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text(encoding="utf-8"))
    if data.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported baseline version {data.get('version')!r}"
            f" (expected {FORMAT_VERSION})")
    keys: Counter = Counter()
    for entry in data.get("suppressions", []):
        keys[(entry["file"], entry["code"], entry["message"])] += 1
    return keys


def save(path: Path, violations: List[Violation]) -> None:
    """Freeze the given findings as the new baseline (sorted, stable)."""
    entries = [{"file": v.file, "line": v.line, "code": v.code,
                "message": v.message}
               for v in sorted(violations,
                               key=lambda v: (v.file, v.code, v.line))]
    payload = {"version": FORMAT_VERSION,
               "generated_by": "python -m repro_torch.analysis.lint"
                               " --write-baseline",
               "suppressions": entries}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n", encoding="utf-8")


def apply(violations: List[Violation], baseline: Counter
          ) -> Tuple[List[Violation], List[Violation], List[Key]]:
    """Split findings into (new, suppressed) and report stale keys.

    Each baseline entry absorbs at most its multiplicity of matching
    findings; leftovers are new.  Keys with unused multiplicity are
    stale — the debt was paid down (or the code deleted) and the entry
    should be pruned."""
    budget: Dict[Key, int] = dict(baseline)
    new: List[Violation] = []
    suppressed: List[Violation] = []
    for v in violations:
        if budget.get(v.key, 0) > 0:
            budget[v.key] -= 1
            suppressed.append(v)
        else:
            new.append(v)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return new, suppressed, stale
