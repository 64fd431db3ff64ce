"""Pluggable AST checkers over the port's tree: a copy of
``lodestar_tpu/analysis/ast_lint.py`` pointed at ``lodestar_tpu_torch/``.

Each checker is a small class with a stable ``rule`` id and a
``check(path, tree, source)`` method returning ``Violation``s; the
runner parses each file once and fans the tree out to every checker.
Scope is the ``lodestar_tpu_torch/`` package (tests lint themselves by
running, and ``test_cost`` audits them).

Rules (the JAX package's, with the port's blocking calls):

- ``async-blocking-sync``   blocking syncs lexically inside ``async def``:
  ``.result()``, ``time.sleep``, ``torch.cuda.synchronize`` and an
  event's or a stream's ``.synchronize()``, and the host reads
  ``.item()`` and ``.tolist()`` of a tensor (each waits for the card); the
  JAX calls ``.block_until_ready()`` and ``device_get`` stay in the set, so
  the rule gives the JAX checker's findings on the JAX fixtures.  Route
  the call through ``asyncio.to_thread`` (passing the bound method is the
  sanctioned shape: a reference, not a call).
- ``tracing-wallclock``     ``time.time()`` in the port's ``tracing/``
  package, and nested in a TRACER call's arguments elsewhere.
- ``await-holding-lock``    ``await`` lexically inside a ``with`` block whose
  context manager looks like a (threading) lock.
- ``bls-silent-except``     ``except`` arms in ``crypto/bls/`` or
  ``chain/bls_pool.py`` that neither journal, count, nor re-raise.
- ``metrics-coverage``      every metric registered in the port's
  ``metrics/registry.py`` must be named by a dashboard, a doc or the
  port's section of ``README.md`` (``metrics_coverage``).

Suppression: ``# lint: disable=<rule>`` on the flagged line
(``report.suppressed_rules``).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence

from .report import Violation, filter_suppressed

# ---------------------------------------------------------------------------
# checker base + helpers
# ---------------------------------------------------------------------------


class Checker:
    rule: str = "base"
    description: str = ""

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        raise NotImplementedError


def _terminal_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name/Attribute chain (``a.b.c`` -> c)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_dotted(node: ast.AST, *parts: str) -> bool:
    """True when ``node`` is exactly the dotted name parts (e.g. time.time)."""
    for part in reversed(parts[1:]):
        if not (isinstance(node, ast.Attribute) and node.attr == part):
            return False
        node = node.value
    return isinstance(node, ast.Name) and node.id == parts[0]


def _walk_skip_nested_defs(body: Sequence[ast.stmt]):
    """Yield nodes in ``body`` without descending into nested function
    definitions (their bodies run in their own execution context)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# async-blocking-sync
# ---------------------------------------------------------------------------

#: ``.result()``, a CUDA sync (``torch.cuda.synchronize()``, an event's or a
#: stream's ``.synchronize()``), a tensor's host read, and the JAX names
_BLOCKING_ATTRS = {"result", "synchronize", "item", "tolist", "block_until_ready"}
_BLOCKING_DOTTED = (("time", "sleep"), ("jax", "device_get"))
_BLOCKING_NAMES = {"device_get"}


class AsyncBlockingSyncChecker(Checker):
    rule = "async-blocking-sync"
    description = "blocking sync call lexically inside async def"

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        out: List[Violation] = []
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _walk_skip_nested_defs(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                blocking = (
                    (isinstance(f, ast.Attribute) and f.attr in _BLOCKING_ATTRS)
                    or any(_is_dotted(f, *d) for d in _BLOCKING_DOTTED)
                    or (isinstance(f, ast.Name) and f.id in _BLOCKING_NAMES)
                )
                if blocking:
                    name = _terminal_name(f) or "<call>"
                    out.append(
                        Violation(
                            self.rule, path, node.lineno,
                            f"blocking call {name}() inside async def "
                            f"{fn.name} — wrap in asyncio.to_thread "
                            f"(pass the bound method, don't call it)",
                        )
                    )
        return out


# ---------------------------------------------------------------------------
# tracing-wallclock
# ---------------------------------------------------------------------------


def _is_tracer_call(call: ast.Call) -> bool:
    """A call on the TRACER singleton (TRACER.add_span(...), tracer.instant
    via any name ending in the tracer method set)."""
    f = call.func
    for sub in ast.walk(f):
        if isinstance(sub, ast.Name) and sub.id == "TRACER":
            return True
    return isinstance(f, ast.Attribute) and f.attr in ("add_span", "instant")


class TracingWallclockChecker(Checker):
    rule = "tracing-wallclock"
    description = "time.time() in tracing code (monotonic_ns only)"

    def _flag(self, path, node, out, where):
        out.append(
            Violation(
                self.rule, path, node.lineno,
                f"time.time() {where} — tracing timestamps must be "
                f"time.monotonic_ns() (one clock across threads, no NTP steps)",
            )
        )

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        out: List[Violation] = []
        in_tracing_pkg = "tracing" in os.path.normpath(path).split(os.sep)
        if in_tracing_pkg:
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and _is_dotted(
                    node.func, "time", "time"
                ):
                    self._flag(path, node, out, "in the tracing package")
            return out
        # elsewhere: flag time.time() nested in a TRACER call's arguments
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_tracer_call(node)):
                continue
            for arg in node.args + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Call) and _is_dotted(
                        sub.func, "time", "time"
                    ):
                        self._flag(path, sub, out, "feeding a TRACER span")
        return out


# ---------------------------------------------------------------------------
# await-holding-lock
# ---------------------------------------------------------------------------


def _looks_like_lock(expr: ast.AST) -> bool:
    name = _terminal_name(expr)
    if name is None and isinstance(expr, ast.Call):
        name = _terminal_name(expr.func)
    return name is not None and "lock" in name.lower()


class AwaitHoldingLockChecker(Checker):
    rule = "await-holding-lock"
    description = "await while holding a (threading) lock"

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(tree):
            # sync `with` only: `async with` managers are asyncio locks,
            # which are designed to be held across awaits
            if not isinstance(node, ast.With):
                continue
            if not any(_looks_like_lock(i.context_expr) for i in node.items):
                continue
            for inner in _walk_skip_nested_defs(node.body):
                if isinstance(inner, ast.Await):
                    lock = next(
                        _terminal_name(i.context_expr) or "<lock>"
                        for i in node.items
                        if _looks_like_lock(i.context_expr)
                    )
                    out.append(
                        Violation(
                            self.rule, path, inner.lineno,
                            f"await while holding {lock} (acquired line "
                            f"{node.lineno}) — a thread lock held across a "
                            f"suspension point stalls every other thread",
                        )
                    )
        return out


# ---------------------------------------------------------------------------
# bls-silent-except
# ---------------------------------------------------------------------------

#: call terminal names that count as journaling / counting / propagating:
#: journal (JOURNAL.record), any logger method (WARNING+ mirrors into the
#: journal via utils/logger.JournalHandler), metric increments, and
#: exception propagation onto a future
_EXCEPT_HANDLED_CALLS = {
    "record", "debug", "info", "warning", "error", "exception", "critical",
    "log", "inc", "set_exception",
}
#: substrings marking a dedicated accounting helper (``_pack_reject``,
#: ``_count_drop``, ``_degrade``, ``_record_executor_failure``,
#: ``_native_fallback_verdict``, ``maybe_raise`` re-injection, ...)
_EXCEPT_HANDLED_SUBSTRINGS = (
    "reject", "drop", "count", "degrade", "record", "fallback", "requeue",
)


def _bls_scope(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    if "crypto" in parts and "bls" in parts:
        return True
    return parts[-2:] == ["chain", "bls_pool.py"]


class BlsSilentExceptChecker(Checker):
    """Every ``except`` arm on the BLS verification path must journal,
    count, or re-raise.  A silent swallow here turns a lost device, a
    failed compile, or a dropped verdict into an invisible non-event —
    exactly the faults the chaos plane (lodestar_tpu_torch/chaos) injects
    to prove diagnosability.  Scope: ``crypto/bls/`` and
    ``chain/bls_pool.py`` (the dispatch path proper; the rest of the tree
    has its own disciplines)."""

    rule = "bls-silent-except"
    description = "except arm on the BLS path swallows without evidence"

    def _handled(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.AugAssign):
                return True  # counter += n
            if isinstance(node, ast.Call):
                name = _terminal_name(node.func)
                if name is None:
                    continue
                low = name.lower()
                if name in _EXCEPT_HANDLED_CALLS or any(
                    sub in low for sub in _EXCEPT_HANDLED_SUBSTRINGS
                ):
                    return True
        return False

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        if not _bls_scope(path):
            return []
        out: List[Violation] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if self._handled(handler):
                    continue
                exc = (
                    ast.unparse(handler.type) if handler.type is not None
                    else "<bare>"
                )
                out.append(
                    Violation(
                        self.rule, path, handler.lineno,
                        f"except {exc} swallows without journaling, "
                        f"counting, or re-raising — a fault on the BLS "
                        f"path must leave evidence (JOURNAL.record / "
                        f"logger.* / a counter / raise)",
                    )
                )
        return out


# ---------------------------------------------------------------------------
# metrics-coverage (absorbed from tools/check_metrics_coverage.py)
# ---------------------------------------------------------------------------


class MetricsCoverageChecker(Checker):
    """Repo-level checker: runs once (on registry.py) rather than per file."""

    rule = "metrics-coverage"
    description = "registered metric referenced by no dashboard and no doc"

    def __init__(self, repo: str):
        self.repo = repo

    def check(self, path: str, tree: ast.AST, source: str) -> List[Violation]:
        from . import metrics_coverage

        report = metrics_coverage.check(self.repo)
        out: List[Violation] = []
        for metric, cov in report.items():
            if cov["dashboards"] or cov["docs"]:
                continue
            line = 0
            for i, text in enumerate(source.splitlines(), 1):
                if metric in text:
                    line = i
                    break
            out.append(
                Violation(
                    self.rule, path, line,
                    f"metric {metric} appears in no dashboards/*.json, no "
                    f"docs/*.md and not in README.md's port section — add a "
                    f"panel or a docs row",
                )
            )
        return out


# ---------------------------------------------------------------------------
# the run over the tree
# ---------------------------------------------------------------------------

DEFAULT_CHECKERS = (
    AsyncBlockingSyncChecker,
    TracingWallclockChecker,
    AwaitHoldingLockChecker,
    BlsSilentExceptChecker,
)

_REGISTRY_REL = os.path.join("lodestar_tpu_torch", "metrics", "registry.py")


def lint_source(
    source: str, path: str, checkers: Optional[Sequence[Checker]] = None
) -> List[Violation]:
    """Run checkers over one in-memory source (fixtures, editors).  ``path``
    is whatever the rules should scope on — it need not exist on disk."""
    if checkers is None:
        checkers = [c() for c in DEFAULT_CHECKERS]
    tree = ast.parse(source, filename=path)
    found: List[Violation] = []
    for checker in checkers:
        found.extend(checker.check(path, tree, source))
    return filter_suppressed(found, {path: source})


def iter_py_files(repo: str, rel_root: str = "lodestar_tpu_torch"):
    root = os.path.join(repo, rel_root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield os.path.relpath(full, repo)


def run_ast_lint(
    repo: str,
    checkers: Optional[Sequence[Checker]] = None,
    with_metrics: bool = True,
) -> List[Violation]:
    """Lint every .py file under ``lodestar_tpu_torch/`` plus the repo-level
    metrics-coverage rule.  Returns suppression-filtered violations."""
    if checkers is None:
        checkers = [c() for c in DEFAULT_CHECKERS]
    sources: Dict[str, str] = {}
    found: List[Violation] = []
    for rel in iter_py_files(repo):
        with open(os.path.join(repo, rel)) as f:
            src = f.read()
        sources[rel] = src
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            found.append(
                Violation("syntax-error", rel, e.lineno or 0, str(e.msg))
            )
            continue
        for checker in checkers:
            found.extend(checker.check(rel, tree, src))
    if with_metrics:
        reg = os.path.join(repo, _REGISTRY_REL)
        if os.path.exists(reg):
            with open(reg) as f:
                reg_src = f.read()
            sources[_REGISTRY_REL] = reg_src
            found.extend(
                MetricsCoverageChecker(repo).check(
                    _REGISTRY_REL, ast.parse(reg_src), reg_src
                )
            )
    return filter_suppressed(found, sources)
