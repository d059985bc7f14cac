"""``python -m repro_torch.analysis.lint`` — the port's AST lint gate.

Runs the :mod:`repro_torch.analysis.checkers` rules over library code
(``src/repro_torch`` by default, without its ``benchmarks/``,
``examples/`` and ``scripts/`` folders: fixed seeds there are the point,
not a bug, and the JAX package's counterparts of those folders sit
outside ``src/repro``) plus the repo-level dead-backend check, diffs the
findings against the checked-in baseline
(``src/repro_torch/analysis/baseline.json``) and exits non-zero on
anything new.  Pure stdlib — no torch import.

Exit codes: 0 clean (all findings baselined), 1 new findings, 2 usage.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Iterable, List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.checkers import (Checker, Dead01UnexercisedBackend,
                                           RULES, Violation, all_checkers,
                                           check_file)

DEFAULT_PATHS = ("src/repro_torch",)
EXCLUDE_PARTS = {"__pycache__", "analysis_fixtures"}
#: folders a directory walk leaves out unless it starts inside them
OUT_OF_SCOPE = ("src/repro_torch/benchmarks", "src/repro_torch/examples",
                "src/repro_torch/scripts")


def _within(path: Path, folder: Path) -> bool:
    return path == folder or folder in path.parents


def collect_files(root: Path, paths: Iterable[str]) -> List[Path]:
    root = root.resolve()
    files: List[Path] = []
    for p in paths:
        target = ((root / p) if not Path(p).is_absolute()
                  else Path(p)).resolve()
        if target.is_file():
            files.append(target)
            continue
        skip = [root / s for s in OUT_OF_SCOPE
                if not _within(target, root / s)]
        files.extend(
            f for f in sorted(target.rglob("*.py"))
            if not EXCLUDE_PARTS & set(f.parts)
            and not any(_within(f, s) for s in skip))
    return files


def run_lint(root: Path, paths: Iterable[str] = DEFAULT_PATHS,
             checkers: Optional[List[Checker]] = None,
             dead: Optional[Dead01UnexercisedBackend] = None
             ) -> List[Violation]:
    """All findings over ``paths`` (repo-relative), sorted.  ``dead``
    (the repo-level backend-liveness check) defaults to the real
    registry + tests tree; pass ``None``-able custom instances from
    tests."""
    root = root.resolve()
    out: List[Violation] = []
    for f in collect_files(root, paths):
        rel = f.resolve().relative_to(root).as_posix()
        out.extend(check_file(f, rel, checkers))
    if dead is None:
        dead = Dead01UnexercisedBackend()
    out.extend(dead.check_repo(root))
    return sorted(out, key=lambda v: (v.file, v.line, v.code))


def _markdown_report(new: List[Violation], suppressed: List[Violation],
                     stale) -> str:
    lines = ["### repro_torch.analysis lint", "",
             f"- new violations: **{len(new)}**",
             f"- baselined (frozen debt): {len(suppressed)}",
             f"- stale baseline entries: {len(stale)}", ""]
    if new:
        lines += ["| location | rule | finding |", "|---|---|---|"]
        lines += [f"| `{v.file}:{v.line}` | {v.code} | {v.message} |"
                  for v in new]
    else:
        lines.append("clean — no findings outside the baseline.")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific AST lint (DET01/MUT01/OVF01/TRC01/"
                    "OBS01/DEAD01) with a frozen-debt baseline")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to lint, relative to --root "
                         "(default: src/repro_torch without its "
                         "benchmarks/, examples/ and scripts/)")
    ap.add_argument("--root", default=".",
                    help="repo root paths/baseline are relative to")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (src/repro_torch/analysis/"
                         "baseline.json); "
                         "omit to report everything as new")
    ap.add_argument("--write-baseline", action="store_true",
                    help="refreeze: write ALL current findings to "
                         "--baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (e.g. DET01,MUT01)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--markdown-out", default=None,
                    help="also write a markdown report")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, title in RULES.items():
            print(f"{code}  {title}")
        return 0

    root = Path(args.root)
    checkers: Optional[List[Checker]] = None
    dead: Optional[Dead01UnexercisedBackend] = None
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - set(RULES)
        if unknown:
            print(f"unknown rules: {sorted(unknown)} "
                  f"(known: {sorted(RULES)})", file=sys.stderr)
            return 2
        checkers = [c for c in all_checkers() if c.code in wanted]
        dead = (Dead01UnexercisedBackend() if "DEAD01" in wanted
                else _NO_DEAD)

    violations = run_lint(root, args.paths, checkers, dead)

    if args.write_baseline:
        if not args.baseline:
            print("--write-baseline needs --baseline PATH",
                  file=sys.stderr)
            return 2
        baseline_mod.save(root / args.baseline, violations)
        print(f"froze {len(violations)} finding(s) into {args.baseline}")
        return 0

    base = (baseline_mod.load(root / args.baseline)
            if args.baseline else None)
    if base is not None:
        new, suppressed, stale = baseline_mod.apply(violations, base)
    else:
        new, suppressed, stale = violations, [], []

    for v in new:
        print(v.render())
    for key in stale:
        print(f"note: stale baseline entry (debt paid — prune with "
              f"--write-baseline): {key[0]} {key[1]} {key[2]}")
    summary = (f"{len(new)} new finding(s), {len(suppressed)} baselined, "
               f"{len(stale)} stale baseline entr(y/ies)")
    print(("FAIL: " if new else "ok: ") + summary)

    if args.markdown_out:
        Path(args.markdown_out).write_text(
            _markdown_report(new, suppressed, stale), encoding="utf-8")
    return 1 if new else 0


class _NoDead(Dead01UnexercisedBackend):
    def check_repo(self, root):
        return []


_NO_DEAD = _NoDead()

if __name__ == "__main__":
    sys.exit(main())
