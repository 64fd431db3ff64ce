"""Metrics coverage of the port: which metrics of the port's registry an
operator can find.

The port of ``lodestar_tpu/analysis/metrics_coverage.py``.  The corpus is
the JAX rule's, ``dashboards/*.json`` and ``docs/*.md``, and the port's
section of ``README.md`` (from its heading to the next second-level
heading): the dashboards and the docs are the JAX package's and stay as
they are, so a metric only the port registers is documented there.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

# r.counter("name", ...) / r.gauge(...) / r.histogram(...) in registry.py;
# \s* spans the newline the call's wrapping produces
_METRIC_RE = re.compile(r"r\.(?:counter|gauge|histogram)\(\s*\"([^\"]+)\"")

REGISTRY_REL = os.path.join("lodestar_tpu_torch", "metrics", "registry.py")
#: the heading of the port's section of README.md
README_SECTION = "## The PyTorch/CUDA port"


def registered_metrics(repo: str) -> List[str]:
    with open(os.path.join(repo, REGISTRY_REL)) as f:
        return _METRIC_RE.findall(f.read())


def _corpus(repo: str, subdir: str, exts: tuple) -> Dict[str, str]:
    out: Dict[str, str] = {}
    root = os.path.join(repo, subdir)
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if name.endswith(exts):
            with open(os.path.join(root, name)) as f:
                out[os.path.join(subdir, name)] = f.read()
    return out


def readme_section(repo: str) -> str:
    """The port's section of README.md ("" when there is none)."""
    path = os.path.join(repo, "README.md")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        text = f.read()
    start = text.find(README_SECTION)
    if start < 0:
        return ""
    nxt = re.search(r"^## ", text[start + len(README_SECTION):], re.M)
    return text[start:] if nxt is None else text[start:start + len(README_SECTION) + nxt.start()]


def check(repo: str) -> Dict[str, Dict[str, List[str]]]:
    """Per-metric coverage: which dashboards and docs name it (the port's
    README section counts as a doc)."""
    dashboards = _corpus(repo, "dashboards", (".json",))
    docs = _corpus(repo, "docs", (".md",))
    docs["README.md#port"] = readme_section(repo)
    report: Dict[str, Dict[str, List[str]]] = {}
    for metric in registered_metrics(repo):
        report[metric] = {
            "dashboards": [p for p, text in dashboards.items() if metric in text],
            "docs": [p for p, text in docs.items() if metric in text],
        }
    return report
