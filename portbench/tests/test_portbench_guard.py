"""The import guard compares whole top-level names."""

import os
import subprocess
import sys

from portbench.guard import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_whole_names():
    mods = {"lodestar_tpu_torch": 1, "lodestar_tpu_torch.chain": 1, "jaxtyping": 1,
            "lodestar_tpu": 1, "lodestar_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1, "flax": 1}
    assert forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla", "lodestar_tpu",
                                       "lodestar_tpu.ops"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.run, portbench.harness, portbench.devtrace, portbench.controls;"
            "import portbench.metrics;"
            "import lodestar_tpu_torch.chain.bls_pool, lodestar_tpu_torch.crypto.bls.torch_verifier;"
            "from portbench.guard import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
