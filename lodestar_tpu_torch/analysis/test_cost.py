"""The cost census of the port's CPU tests: which tests run a whole device
program's plain versions, and whether torch is pinned to one intra-op
thread while they do.

The port's counterpart of ``lodestar_tpu/analysis/compile_cost.py``.  The
JAX layer proves which tests materialize device programs, because tier-1
died at its time limit with no failing test; on the CPU the port compiles
nothing, and its cost is the plain versions of a whole program (a bucket-4
verdict is some ten seconds of one core's tensor ops).  Under the test
runner's several workers, each with a pool of spinning intra-op threads,
such a test multiplies its wall many times over (one requeue test took
1,341.6 s of a six-worker tier-1 run unpinned, and 68 s pinned on an
eight-core host alone): that is the rule.

A static AST census over ``tests/test_torch_*.py`` (stdlib only: nothing is
imported or run).  A test *runs a program* when its body, the module's
helpers it calls (transitively) or the module's fixtures it requests:

- make a ``TorchBlsVerifier`` (or ``cli.make_verifier`` / ``make_pool``)
  whose ``_program`` they do not stub, and verify, dispatch or warm
  (``verify_signature_sets[_async]``, ``dispatch``, ``warmup[_async]``,
  ``warmup_sharded``, a ``BlsBatchPool`` over it); or
- call an entry of the port's ``fused_verify``, ``batch_verify`` or
  ``sharded_verify`` (``miller_product*``, ``verify_signature_sets*``,
  ``local_body``, ``finish``), or make a ``ShardedProgram`` or
  ``MeshProgram``.

Tests marked for the card (``pytest.mark.cuda``) and slow-marked files
are left out.  A test is *pinned* when a fixture of its module that it
runs under (autouse, or requested) or its own body calls
``torch.set_num_threads(1)``.

Rule ``torch-test-threads``: a program-running test that is not pinned.
The census (``census``) also records each such test's buckets and shard
counts where the source gives them as constants.
"""

from __future__ import annotations

import ast
import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from .report import Violation, filter_suppressed

RULE = "torch-test-threads"

_VERIFIER_MAKERS = {"TorchBlsVerifier", "make_verifier", "make_pool"}
_DRIVES = {"verify_signature_sets", "verify_signature_sets_async", "dispatch", "warmup",
           "warmup_async", "warmup_sharded", "BlsBatchPool"}
_PROGRAM_MODULES = {"fused_verify", "batch_verify", "sharded_verify"}
#: their whole-program entries (the sharded tier's pieces too)
_PROGRAM_ENTRY_PREFIXES = ("miller_product", "verify_signature_sets")
_PROGRAM_ENTRIES = {"local_body", "finish"}
_PROGRAM_CLASSES = {"ShardedProgram", "MeshProgram"}
#: a verifier whose program (or its entry) is a host stub runs no program
_STUBBED = {"_program", "_entry"}


def _is_entry(name: str) -> bool:
    return name.startswith(_PROGRAM_ENTRY_PREFIXES) or name in _PROGRAM_ENTRIES


@dataclass
class ProgramTest:
    """One test that runs a whole device program's plain versions."""

    path: str
    test: str
    line: int
    pinned: bool
    how: List[str] = field(default_factory=list)
    buckets: List[int] = field(default_factory=list)
    shards: List[int] = field(default_factory=list)


def _name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_fixture(fn: ast.FunctionDef) -> Optional[dict]:
    """The fixture's keywords (``autouse``) when ``fn`` is a pytest fixture."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _name(target) == "fixture":
            kw = {}
            if isinstance(dec, ast.Call):
                for k in dec.keywords:
                    if isinstance(k.value, ast.Constant):
                        kw[k.arg] = k.value.value
            return kw
    return None


def _marked_cuda(decorators: Sequence[ast.AST]) -> bool:
    for dec in decorators:
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and sub.attr in ("cuda", "slow") and \
                    _name(sub.value) == "mark":
                return True
    return False


class _Facts:
    """What one function does, by itself."""

    def __init__(self, fn: ast.AST, program_names: Set[str]):
        self.calls: Set[str] = set()        # plain names called (module helpers)
        self.makes_verifier = False
        self.stubs = False
        self.drives = False
        self.direct: List[str] = []         # direct program calls
        self.pins = False
        self.buckets: List[int] = []
        self.shards: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _name(node.func)
                if isinstance(node.func, ast.Name):
                    self.calls.add(node.func.id)
                if name in _VERIFIER_MAKERS:
                    self.makes_verifier = True
                    self._read_shape(node)
                if name in _DRIVES:
                    self.drives = True
                if name in _PROGRAM_CLASSES:
                    self.direct.append(name)
                elif isinstance(node.func, ast.Attribute) and _is_entry(name) and \
                        _root(node.func) in program_names:
                    self.direct.append(f"{_root(node.func)}.{name}")
                elif isinstance(node.func, ast.Name) and _is_entry(name) and \
                        name in program_names:
                    self.direct.append(name)
                if name == "set_num_threads" and node.args and \
                        isinstance(node.args[0], ast.Constant) and node.args[0].value == 1:
                    self.pins = True
                if name == "setattr" and len(node.args) >= 2 and \
                        isinstance(node.args[1], ast.Constant) and node.args[1].value in _STUBBED:
                    self.stubs = True
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and t.attr in _STUBBED:
                        self.stubs = True

    def _read_shape(self, call: ast.Call) -> None:
        for kw in call.keywords:
            if kw.arg == "buckets" and isinstance(kw.value, (ast.Tuple, ast.List)):
                self.buckets += [e.value for e in kw.value.elts
                                 if isinstance(e, ast.Constant) and isinstance(e.value, int)]
            if kw.arg == "devices":
                v = kw.value
                if isinstance(v, (ast.List, ast.Tuple)):
                    self.shards.append(len(v.elts))
                elif isinstance(v, ast.BinOp) and isinstance(v.op, ast.Mult) and \
                        isinstance(v.left, ast.List) and isinstance(v.right, ast.Constant):
                    self.shards.append(len(v.left.elts) * v.right.value)


def _program_names(tree: ast.Module) -> Set[str]:
    """The port's fused_verify / batch_verify / sharded_verify as bound in
    a test module (the JAX package's modules of the same names are not
    the port's programs), and the names imported from them."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "lodestar_tpu_torch":
            last = node.module.split(".")[-1]
            for alias in node.names:
                if alias.name in _PROGRAM_MODULES or last in _PROGRAM_MODULES:
                    names.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if parts[0] == "lodestar_tpu_torch" and parts[-1] in _PROGRAM_MODULES:
                    names.add(alias.asname or alias.name)
    return names


def census_source(source: str, path: str) -> List[ProgramTest]:
    """The program-running tests of one test module's source."""
    tree = ast.parse(source, filename=path)
    if any(isinstance(n, ast.Assign) and any(_name(t) == "pytestmark" for t in n.targets)
           and _marked_cuda([n.value]) for n in tree.body):
        return []
    program_names = _program_names(tree)
    funcs: Dict[str, ast.FunctionDef] = {}
    tests: List[ast.FunctionDef] = []
    for node in tree.body:
        members = node.body if isinstance(node, ast.ClassDef) else [node]
        for fn in members:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(fn.name, fn)
                if fn.name.startswith("test"):
                    tests.append(fn)
    facts = {name: _Facts(fn, program_names) for name, fn in funcs.items()}
    fixtures = {name: kw for name, fn in funcs.items()
                if (kw := _is_fixture(fn)) is not None}
    autouse = [name for name, kw in fixtures.items() if kw.get("autouse")]

    def closure(roots: Sequence[str]) -> List[_Facts]:
        seen, stack, out = set(), list(roots), []
        while stack:
            name = stack.pop()
            if name in seen or name not in facts:
                continue
            seen.add(name)
            out.append(facts[name])
            stack.extend(facts[name].calls)
            fn = funcs[name]
            stack.extend(a.arg for a in fn.args.args if a.arg in fixtures)
        return out

    found = []
    for fn in tests:
        if _marked_cuda(fn.decorator_list):
            continue
        reach = closure([fn.name] + autouse)
        real = [f for f in reach if f.makes_verifier and not f.stubs]
        stubbed = any(f.stubs for f in reach)
        how = []
        if real and not stubbed and any(f.drives for f in reach):
            how.append("verifier")
        how += sorted({d for f in reach for d in f.direct})
        if not how:
            continue
        found.append(ProgramTest(
            path=path, test=fn.name, line=fn.lineno, pinned=any(f.pins for f in reach), how=how,
            buckets=sorted({b for f in reach for b in f.buckets}),
            shards=sorted({s for f in reach for s in f.shards})))
    return found


def test_files(repo: str) -> List[str]:
    return sorted(os.path.relpath(p, repo)
                  for p in glob.glob(os.path.join(repo, "tests", "test_torch_*.py")))


def census(repo: str, files: Optional[Sequence[str]] = None) -> List[ProgramTest]:
    out: List[ProgramTest] = []
    for rel in files if files is not None else test_files(repo):
        with open(os.path.join(repo, rel)) as f:
            out += census_source(f.read(), rel)
    return out


def check_source(source: str, path: str) -> List[Violation]:
    """The rule over one test module's source (fixtures)."""
    out = [Violation(RULE, t.path, t.line,
                     f"{t.test} runs a whole device program's plain versions ({', '.join(t.how)}) "
                     f"without torch pinned to one intra-op thread: pin it in a module-scoped "
                     f"autouse fixture (torch.set_num_threads(1), restored after)")
           for t in census_source(source, path) if not t.pinned]
    return filter_suppressed(out, {path: source})


def audit_test_cost(repo: str, files: Optional[Sequence[str]] = None) -> List[Violation]:
    out: List[Violation] = []
    for rel in files if files is not None else test_files(repo):
        with open(os.path.join(repo, rel)) as f:
            out += check_source(f.read(), rel)
    return out
