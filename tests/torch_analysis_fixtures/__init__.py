"""Known-bad fixtures of the port's analysis layer (``lodestar_tpu_torch/
analysis``).

One fixture per rule (or family); tests/test_torch_analysis.py asserts each
rule fires exactly on the lines marked ``# VIOLATION`` (``// VIOLATION`` in
a C++ fixture) and nowhere in the live tree.  The AST fixtures
(``bad_async_blocking.py``, ``bad_test_threads.py``) are parsed, never
imported; ``bad_programs.py`` and ``bad_limb_overflow.py`` are imported and
traced; ``bad_stage_race.cuh`` is spliced into a copy of the kernel
headers for the host walk.
"""

import os


def fixture_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def fixture_source(name: str) -> str:
    with open(fixture_path(name), encoding="utf-8") as f:
        return f.read()


def violation_lines(source: str) -> list:
    """1-based line numbers carrying a ``# VIOLATION`` or ``// VIOLATION``
    marker."""
    return [i for i, line in enumerate(source.splitlines(), 1)
            if "# VIOLATION" in line or "// VIOLATION" in line]
