"""Directory-driven spec-test runner.

Reference: packages/spec-test-util/src/single.ts:93 — each test case is a
leaf directory whose files (``*.yaml``, ``*.ssz``, ``*.ssz_snappy``) are
the inputs/expected outputs; a runner maps loaded inputs to a result which
is compared against the expected output.

The official vectors (ethereum/consensus-spec-tests) are an external
download; this harness discovers them under ``SPEC_TESTS_DIR`` (or
``<repo>/spec-tests``) and is a no-op if absent (it downloads nothing;
the reference downloads them in CI, test/spec/downloadTests.ts).  Snappy-framed files decode via the
pure-Python codec (utils/snappy.py).

Layout of a case directory (consensus-spec-tests convention):
  tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>/
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import yaml

from ..utils.snappy import frame_uncompress


def spec_tests_root() -> Optional[Path]:
    env = os.environ.get("SPEC_TESTS_DIR")
    if env:
        p = Path(env)
        return p if p.is_dir() else None
    default = Path(__file__).resolve().parents[2] / "spec-tests"
    return default if default.is_dir() else None


@dataclasses.dataclass
class SpecTestCase:
    path: Path
    config: str
    fork: str
    runner: str
    handler: str
    suite: str
    name: str
    files: Dict[str, Any]  # stem -> loaded content (yaml obj or raw bytes)

    def bytes_of(self, stem: str) -> bytes:
        v = self.files[stem]
        if not isinstance(v, (bytes, bytearray)):
            raise TypeError(f"{stem} is not raw bytes")
        return bytes(v)


def load_spec_test_case(case_dir: Path, meta: Optional[Dict[str, str]] = None) -> SpecTestCase:
    files: Dict[str, Any] = {}
    for f in sorted(case_dir.iterdir()):
        if f.is_dir():
            continue
        if f.suffix == ".yaml":
            files[f.stem] = yaml.safe_load(f.read_text())
        elif f.suffix == ".ssz_snappy":
            files[f.stem] = frame_uncompress(f.read_bytes())
        elif f.suffix == ".ssz":
            files[f.stem] = f.read_bytes()
    parts = case_dir.parts
    meta = meta or {}
    return SpecTestCase(
        path=case_dir,
        config=meta.get("config", parts[-6] if len(parts) >= 6 else ""),
        fork=meta.get("fork", parts[-5] if len(parts) >= 5 else ""),
        runner=meta.get("runner", parts[-4] if len(parts) >= 4 else ""),
        handler=meta.get("handler", parts[-3] if len(parts) >= 3 else ""),
        suite=meta.get("suite", parts[-2] if len(parts) >= 2 else ""),
        name=parts[-1],
        files=files,
    )


def collect_spec_test_cases(
    runner: str,
    handler: Optional[str] = None,
    config: str = "minimal",
    fork: str = "phase0",
    root: Optional[Path] = None,
) -> List[Path]:
    """Find case directories for tests/<config>/<fork>/<runner>/<handler>/*/*."""
    root = root or spec_tests_root()
    if root is None:
        return []
    base = root / "tests" / config / fork / runner
    if handler:
        base = base / handler
    if not base.is_dir():
        return []
    out: List[Path] = []
    for suite_dir in sorted(base.glob("*/*") if handler else base.glob("*/*/*")):
        if suite_dir.is_dir():
            out.append(suite_dir)
    return out


def describe_directory_spec_test(
    case_dirs: List[Path],
    runner_fn: Callable[[SpecTestCase], Any],
    expect_fn: Callable[[SpecTestCase], Any],
    compare_fn: Optional[Callable[[Any, Any], bool]] = None,
) -> Iterator[tuple]:
    """Yield (case, ok, got, want) for each case — the single.ts loop:
    load inputs, run, compare to expected.  ``runner_fn`` may raise
    ``SkipCase`` to skip a vector."""
    for case_dir in case_dirs:
        case = load_spec_test_case(case_dir)
        try:
            got = runner_fn(case)
        except SkipCase:
            continue
        want = expect_fn(case)
        ok = compare_fn(got, want) if compare_fn else got == want
        yield case, ok, got, want


class SkipCase(Exception):
    pass
