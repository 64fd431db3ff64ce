"""Deterministic fault injection (the port's copy of the JAX package's
``chaos``).

Public surface:

- ``CHAOS``            process-wide controller; ``CHAOS.armed`` is the
                       constant-time disarmed gate every seam reads
- ``FaultPlan`` / ``FaultSpec``   the seeded, deterministic plan
- ``install_from_env`` arming from ``LODESTAR_TPU_CHAOS_PLAN`` (the JSON
                       of ``FaultPlan.to_json()``, the JAX package's format)
- ``corrupt_file``     deterministic byte-flipper for corruption runs
- ``DeviceLostError`` / ``InjectedCompileError`` / ``InjectedIOError`` /
  ``FaultInjected``    the typed injected failures
"""

from .plan import (  # noqa: F401
    CHAOS,
    KNOWN_SEAMS,
    PLAN_ENV,
    ChaosController,
    DeviceLostError,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    InjectedCompileError,
    InjectedIOError,
    corrupt_file,
    install_from_env,
)
