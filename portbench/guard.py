"""The import guard: the benchmark measures the port alone.

A run fails when any loaded module's top-level name (the part before the
first dot) is exactly one of ``FORBIDDEN``: the port's name,
``lodestar_tpu_torch``, begins with the JAX package's, so the names are
compared whole.
"""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "lodestar_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".", 1)[0] in FORBIDDEN)
