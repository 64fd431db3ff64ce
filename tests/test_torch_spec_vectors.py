"""The port's state transition, SSZ, shuffling, fork choice and rewards
over the repo's ``spec-tests/`` vectors, by the same categories and cases
as ``tests/test_spec_vectors.py``: that module's source is run here with
every ``lodestar_tpu`` import pointed at ``lodestar_tpu_torch``, so each of
its tests (runners, configs, expected outputs, the coverage check) holds
the port to the same vectors with the same tolerance (exact roots, bytes
and validity).  Its genesis case runs in ``test_torch_spec_vectors_genesis.py``
(about 25 s), which keeps this file near 50 s on one core."""

import os
import re

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_spec_vectors.py")
#: the tests that run in test_torch_spec_vectors_genesis.py
GENESIS = ("test_genesis_vectors",)


def repointed_source() -> str:
    """tests/test_spec_vectors.py with its imports on the port."""
    with open(_SOURCE, encoding="utf-8") as f:
        code = re.sub(r"\blodestar_tpu\b(?!_torch)", "lodestar_tpu_torch", f.read())
    assert "import jax" not in code and "from jax" not in code
    return code


exec(compile(repointed_source(), _SOURCE, "exec"), globals())  # noqa: S102 - re-pointed
for _name in GENESIS:
    del globals()[_name]
