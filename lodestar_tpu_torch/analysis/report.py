"""The violation record and report format every analysis layer of the port
shares: a copy of ``lodestar_tpu/analysis/report.py``."""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant violation.

    ``rule`` is the stable kebab-case id from the docs/static_analysis.md
    catalogue; ``path`` is repo-relative (or an entry-point name for jaxpr
    findings); ``line`` is 0 when the finding has no source line (IR and
    runtime findings)."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


def format_report(violations: Iterable[Violation]) -> str:
    """Stable, grep-able one-line-per-violation report grouped by rule."""
    vs: List[Violation] = sorted(
        violations, key=lambda v: (v.rule, v.path, v.line)
    )
    if not vs:
        return "lint OK: 0 violations"
    lines = [f"{len(vs)} violation(s):"]
    lines += [f"  {v}" for v in vs]
    return "\n".join(lines)


def to_dicts(violations: Iterable[Violation]) -> List[dict]:
    """JSON-ready form (bench.py extras, --json output)."""
    return [dataclasses.asdict(v) for v in violations]


def suppressed_rules(source_line: str) -> Optional[set]:
    """Parse the inline suppression syntax on one source line.

    ``# lint: disable=rule-a,rule-b`` suppresses those rules on that line;
    ``# lint: disable`` (no ids) suppresses every rule on the line.
    Returns None when the line carries no suppression (including a
    MALFORMED directive — e.g. ``# lint: disable async-blocking-sync``
    with a space instead of ``=`` must not silently become disable-all;
    the still-reported violation is what surfaces the typo), the empty
    set for a bare disable-all, else the set of suppressed rule ids."""
    marker = "# lint: disable"
    idx = source_line.find(marker)
    if idx < 0:
        return None
    rest = source_line[idx + len(marker):].strip()
    if rest == "" or rest.startswith("#"):
        return set()  # bare disable-all (optionally a trailing comment)
    if not rest.startswith("="):
        return None  # malformed — do not suppress anything
    return {r.strip() for r in rest[1:].split(",") if r.strip()}


def filter_suppressed(
    violations: Iterable[Violation], source_by_path: dict
) -> List[Violation]:
    """Drop violations whose flagged source line carries a matching
    ``# lint: disable`` marker.  ``source_by_path`` maps the violation's
    path to the file's text; paths without source (runtime/IR findings)
    are never suppressible."""
    out: List[Violation] = []
    for v in violations:
        src = source_by_path.get(v.path)
        if src is not None and v.line:
            lines = src.splitlines()
            if 0 < v.line <= len(lines):
                rules = suppressed_rules(lines[v.line - 1])
                if rules is not None and (not rules or v.rule in rules):
                    continue
        out.append(v)
    return out
