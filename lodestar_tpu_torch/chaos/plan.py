"""Deterministic fault injection: the plan, the controller, the seams (the
port's copy of the JAX package's ``chaos/plan.py``).

The chaos plane is the *active* half of the robustness stack: the
forensics can diagnose a failure, but only an injector can *induce* the
failures a fleet eventually delivers for free — a lost card mid-flight, a
wedged card, a program that starts failing at its enqueue.

Design constraints, in order (mirroring ``tracing.SpanTracer``):

1. **Zero overhead disarmed.**  Every seam site gates on the single
   attribute read ``CHAOS.armed`` (a plain bool, False unless a plan is
   installed) before building any context or touching any lock.  A
   production node that never arms a plan pays one attribute read per
   seam crossing — nothing else.
2. **Deterministic.**  A ``FaultPlan`` is (seed, fault specs); whether a
   given seam crossing fires is a pure function of the seed, the spec's
   ``after``/``count`` window, and the (deterministic) crossing order —
   so a failure reproduces from its seed alone.  No wall clock, no
   global RNG.
3. **Every injection leaves evidence.**  Each fired fault lands in the
   forensics journal (``chaos.inject``: seed, seam, context) and in the
   controller's ``injected`` log, which rides into every diagnostic
   bundle.

Seams the port's verifier crosses (``crypto/bls/torch_verifier.py``):

========================  ===================================================
``bls.compile``           raised inside ``TorchBlsVerifier.dispatch()``
                          where the program is enqueued (``where=
                          "dispatch"``) — models a failed enqueue or build;
                          the slot is freed, the failure recorded against
                          the executor and the exception raised
``device.loss``           drawn at dispatch; ``PendingVerdict``'s sync
                          raises ``DeviceLostError`` — models a card
                          dropping out mid-flight; drives requeue and
                          quarantine
``device.wedge``          drawn at dispatch; the sync blocks ``wedge_s``
                          seconds (the watchdog window) and THEN raises —
                          models a hung card; drives the watchdog and
                          requeue
========================  ===================================================

The other names of ``KNOWN_SEAMS`` are the JAX package's (``forensics.io``
is crossed by ``forensics/bundle.write_bundle`` here too); a plan written
for the JAX package parses here unchanged (``LODESTAR_TPU_CHAOS_PLAN``).

This module imports nothing from the rest of the package at module
scope (journal access is lazy, at fire time) so low-level modules —
``forensics/bundle`` included — can import ``CHAOS`` without cycles.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import threading
from typing import Any, Dict, List, Optional

#: env var carrying a JSON FaultPlan into a process (a spawned child, or
#: ``python3 chip_smoke.py`` on the card) — see install_from_env()
PLAN_ENV = "LODESTAR_TPU_CHAOS_PLAN"

KNOWN_SEAMS = (
    "bls.compile",
    "device.loss",
    "device.wedge",
    "cache.corrupt",
    "aot.midwrite",
    "bench.kill",
    "forensics.io",
)


class FaultInjected(Exception):
    """Base class of every injected failure — a campaign assertion can
    tell an induced fault from an organic bug by type."""


class DeviceLostError(FaultInjected):
    """The device behind an in-flight batch is gone (injected analog of a
    chip dropping its tunnel: ``result()`` raises instead of returning)."""


class InjectedCompileError(FaultInjected):
    """A compile/program-call failure injected at the ``bls.compile`` seam."""


class InjectedIOError(FaultInjected, OSError):
    """An IO failure injected at the ``forensics.io`` seam (an OSError so
    the bundle writer's per-section isolation sees its usual class)."""


@dataclasses.dataclass
class FaultSpec:
    """One fault: fire at ``seam`` on crossings matching ``match``,
    skipping the first ``after`` matches, then firing on the next
    ``count`` (0 = every match from then on).

    ``match`` compares context keys by equality (e.g. ``{"device":
    "cpu:1", "fused": True}``); keys absent from the crossing context
    never match.  ``probability`` < 1 draws from the plan's seeded RNG —
    still deterministic for a fixed seed and crossing order."""

    seam: str
    match: Optional[Dict[str, Any]] = None
    after: int = 0
    count: int = 1
    probability: float = 1.0
    wedge_s: float = 0.0
    error: str = ""
    # runtime state (not part of the plan identity)
    seen: int = 0
    fired: int = 0

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if not self.match:
            return True
        return all(ctx.get(k) == v for k, v in self.match.items())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seam": self.seam, "match": self.match, "after": self.after,
            "count": self.count, "probability": self.probability,
            "wedge_s": self.wedge_s, "error": self.error,
        }


class FaultPlan:
    """A seeded list of fault specs — the unit a campaign installs."""

    def __init__(self, seed: int = 0, faults: Optional[List[FaultSpec]] = None):
        self.seed = int(seed)
        self.faults: List[FaultSpec] = list(faults or [])
        self._rng = random.Random(self.seed)

    def add(self, seam: str, **kw: Any) -> "FaultPlan":
        self.faults.append(FaultSpec(seam=seam, **kw))
        return self

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [f.to_dict() for f in self.faults]}
        )

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        doc = json.loads(blob)
        if not isinstance(doc, dict):
            # valid JSON that is not a plan object (e.g. a bare faults
            # list) must fail as a *bad plan*, not an AttributeError that
            # bypasses install_from_env's evidence trail
            raise ValueError(f"fault plan must be a JSON object, got {type(doc).__name__}")
        return cls(
            seed=doc.get("seed", 0),
            faults=[FaultSpec(**f) for f in doc.get("faults", [])],
        )


class ChaosController:
    """Process-wide injection point.  ``armed`` is the constant-time
    disarmed gate every seam site reads first; all other state is only
    touched once a plan is installed."""

    def __init__(self):
        self.armed = False  # the ONLY attribute the disarmed hot path reads
        self._lock = threading.Lock()
        self._plan: Optional[FaultPlan] = None
        #: fired-fault log (newest last) — bundles and inspect_bundle's
        #: chaos triage section read this
        self.injected: List[Dict[str, Any]] = []

    # -- arming ---------------------------------------------------------------

    def install(self, plan: FaultPlan) -> "ChaosController":
        with self._lock:
            self._plan = plan
            self.injected = []
            self.armed = True
        self._journal(
            "chaos.install", level="WARNING", seed=plan.seed,
            seams=sorted({f.seam for f in plan.faults}),
            faults=len(plan.faults),
        )
        return self

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self._plan = None
        self._journal("chaos.disarm")

    # -- the seam API ---------------------------------------------------------

    def fire(self, seam: str, **ctx: Any) -> Optional[FaultSpec]:
        """One seam crossing: returns the matching FaultSpec when the
        plan says this crossing fails, else None.  Callers gate on
        ``CHAOS.armed`` first; this method re-checks under the lock so a
        concurrent disarm is safe."""
        with self._lock:
            plan = self._plan
            if not self.armed or plan is None:
                return None
            for spec in plan.faults:
                if spec.seam != seam or not spec.matches(ctx):
                    continue
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if spec.count and spec.fired >= spec.count:
                    continue
                if spec.probability < 1.0 and plan._rng.random() >= spec.probability:
                    continue
                spec.fired += 1
                record = {
                    "seam": seam, "seed": plan.seed, "ctx": dict(ctx),
                    "fired": spec.fired,
                }
                self.injected.append(record)
                break
            else:
                return None
        # journal outside the lock (the journal has its own)
        self._journal("chaos.inject", level="WARNING", seam=seam,
                      seed=plan.seed, **ctx)
        return spec

    def maybe_raise(self, seam: str, **ctx: Any) -> None:
        """Raise the seam's injected exception type when the plan fires."""
        spec = self.fire(seam, **ctx)
        if spec is None:
            return
        msg = spec.error or f"injected fault at {seam} (seed {self._seed()})"
        if seam == "forensics.io":
            raise InjectedIOError(msg)
        if seam == "bls.compile":
            raise InjectedCompileError(msg)
        raise FaultInjected(msg)

    def maybe_kill(self, seam: str = "bench.kill", **ctx: Any) -> None:
        """SIGKILL the calling process when the plan fires (a child's
        death mid-stage — nothing downstream of this returns)."""
        if self.fire(seam, **ctx) is not None:
            os.kill(os.getpid(), signal.SIGKILL)

    # -- introspection --------------------------------------------------------

    def _seed(self) -> Optional[int]:
        plan = self._plan
        return plan.seed if plan is not None else None

    def state(self) -> Dict[str, Any]:
        """Snapshot for diagnostic bundles (forensics/bundle)."""
        with self._lock:
            plan = self._plan
            return {
                "armed": self.armed,
                "seed": plan.seed if plan else None,
                "faults": [
                    dict(f.to_dict(), seen=f.seen, fired=f.fired)
                    for f in plan.faults
                ] if plan else [],
                "injected": [dict(r) for r in self.injected],
            }

    def _journal(self, kind: str, **fields: Any) -> None:
        # lazy: keeps this module import-cycle-free (bundle.py imports us)
        try:
            from ..forensics.journal import JOURNAL

            JOURNAL.record(kind, **fields)
        except Exception:
            pass  # evidence is best-effort; injection must still work


#: process-wide singleton every seam site reads
CHAOS = ChaosController()


def install_from_env(env: Optional[Dict[str, str]] = None) -> bool:
    """Arm CHAOS from the ``LODESTAR_TPU_CHAOS_PLAN`` JSON env var (or
    ``env``, a mapping that holds it): a process that should run under a
    plan calls this first.  Returns True when a plan was armed."""
    blob = (env or os.environ).get(PLAN_ENV)
    if not blob:
        return False
    try:
        CHAOS.install(FaultPlan.from_json(blob))
        return True
    except Exception as e:  # noqa: BLE001 — ANY malformed plan must leave
        # evidence rather than silently never arming (the whole point of
        # the injector is that nothing about it is invisible)
        CHAOS._journal("chaos.bad_plan", level="ERROR", error=str(e)[:200])
        return False


def corrupt_file(path: str, seed: int = 0, flips: int = 16) -> List[int]:
    """Deterministically flip ``flips`` bytes of ``path`` in place (the
    ``cache.corrupt`` seam: persistent-cache / ledger entries don't have
    an in-process hook — real corruption happens to the file between
    processes).  Returns the flipped offsets so a campaign can log them."""
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            data = bytearray(b"\x00")
        # sample WITHOUT replacement: a duplicate offset would XOR the
        # same byte twice and cancel, making the "corruption" a no-op
        offsets = sorted(rng.sample(range(len(data)), min(flips, len(data))))
        for off in offsets:
            data[off] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))
        f.truncate()
    return offsets
