"""A frozen copy of the JAX package's bigint BLS12-381 oracle
(``lodestar_tpu/crypto/bls/{fields,curve,hash_to_curve,pairing}.py``, pure
Python, no JAX): the plain pairing that the CPU tests hold the reference's
C library (``portbench/native/fastbls.c``) against.  Copied, not imported,
so that nothing the benchmark loads is the JAX package."""
