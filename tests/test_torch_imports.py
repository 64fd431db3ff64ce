"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it imports with JAX blocked, and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lodestar_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "lodestar_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _absolute_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [
        (os.path.relpath(f, REPO), name)
        for f in files
        for name in _absolute_imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_port_imports_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'lodestar_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import lodestar_tpu_torch.crypto.bls.torch_verifier\n"
        "import lodestar_tpu_torch.ops.fused_verify\n"
        "import lodestar_tpu_torch.ops.kernels._build\n"
        "import chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and sys.modules[m] is not None"
        " for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from lodestar_tpu_torch import resolve_device
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops.fused_verify import from_packed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = (np.zeros((4, 50), np.float32),) * 6 + (np.ones(4, bool),)
    with pytest.raises(RuntimeError):
        TorchBlsVerifier()
    with pytest.raises(RuntimeError):
        from_packed(packed)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert TorchBlsVerifier(device="cpu").device.type == "cpu"
    assert from_packed(packed, device="cpu")[6].dtype == torch.bool


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
