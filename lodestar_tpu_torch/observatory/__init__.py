"""Performance observatory (the port's copy of the JAX package's
``observatory``, so far its compile ledger: what building, loading and
capturing the port's programs cost, kept across processes).  The device
sampler and the profiler binding are not ported yet."""

from .compile_ledger import COMPILE_LEDGER, KINDS, CompileLedger

__all__ = ["COMPILE_LEDGER", "CompileLedger", "KINDS"]
