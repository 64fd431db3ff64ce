"""The genesis case of ``tests/test_spec_vectors.py`` on the port (see
``test_torch_spec_vectors.py``: the same source, its imports pointed at
``lodestar_tpu_torch``); about 25 s on one core."""

from test_torch_spec_vectors import GENESIS, _SOURCE, repointed_source

exec(compile(repointed_source(), _SOURCE, "exec"), globals())  # noqa: S102 - re-pointed
for _name in [n for n in list(globals()) if n.startswith("test_") and n not in GENESIS]:
    del globals()[_name]
