"""Hot-path span tracing: a batch-correlated timeline of the BLS verifier
(the port's copy of the JAX package's ``tracing``).

The module-level singleton ``TRACER`` is what the instrumented code
records into; it is disabled by default, and every hot-path site gates on
the constant-time ``TRACER.enabled`` check.  ``enable()`` / ``disable()``
flip it process-wide.  The port's verifier records ``bls.pack`` (the
host pack), ``bls.dispatch`` (one enqueue, on a card or the mesh),
``bls.final_exp`` (the sync, the read and the host final exponentiation;
on the full-device path the sync and the read, ``on_device=True``),
``bls.requeue`` (a failed batch sent to another executor, with
``from_device`` / ``to_device``) and the ``bls.warmup_done`` instant; the
batch pool records ``bls.queue_wait``, ``bls.shed`` and ``pool.batch``.

Correlation: a caller parks a merged batch's id in a
``contextvars.ContextVar`` (``set_batch``) before handing work to a
thread; contextvars propagate into ``asyncio.to_thread`` and
``create_task``, so the verifier stamps its spans and journal events with
the batch id without any change to its API.
"""

from __future__ import annotations

import contextvars
from typing import Optional

from .export import to_chrome_trace, write_chrome_trace
from .tracer import Span, SpanTracer

__all__ = [
    "Span",
    "SpanTracer",
    "TRACER",
    "current_batch_id",
    "disable",
    "enable",
    "reset_batch",
    "set_batch",
    "to_chrome_trace",
    "write_chrome_trace",
]

TRACER = SpanTracer()

_CURRENT_BATCH: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "lodestar_tpu_torch_batch_cid", default=None
)


def enable(capacity: Optional[int] = None) -> SpanTracer:
    TRACER.enable(capacity)
    return TRACER


def disable() -> None:
    TRACER.disable()


def current_batch_id() -> Optional[int]:
    """The merged-batch correlation id of the current context (None when
    no caller set one)."""
    return _CURRENT_BATCH.get()


def set_batch(cid: Optional[int]) -> "contextvars.Token":
    return _CURRENT_BATCH.set(cid)


def reset_batch(token: "contextvars.Token") -> None:
    _CURRENT_BATCH.reset(token)
