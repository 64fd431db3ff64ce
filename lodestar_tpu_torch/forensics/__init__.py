"""Flight recorder & failure forensics (the port's copy of the JAX
package's ``forensics``, without its ``jax.monitoring`` listener).

Cooperating pieces, all bounded-memory and safe to leave on in
production:

- ``journal``   — the always-on black-box event ring (dispatch placement,
  executor health, requeues, injected faults, WARNING+ logs through
  ``JournalHandler``);
- ``watchdog``  — the process-wide in-flight dispatch table
  (``INFLIGHT``) plus the stall scanner that turns a silently wedged
  device batch into a metric, a journal ERROR, and an automatic bundle;
- ``bundle`` / ``recorder`` — the diagnostic bundle writer and the
  ``RECORDER`` singleton wiring it to the watchdog, on-demand dumps and
  the crash hooks;
- ``salvage`` — heartbeat bundles a stage child leaves behind when it is
  killed, read back by its parent matched by pid.

Inspect any bundle with ``python -m lodestar_tpu_torch.tools.inspect_bundle
BUNDLE_DIR``.
"""

from .bundle import BUNDLE_SCHEMA, latest_bundle, prune_bundles, write_bundle
from .journal import JOURNAL, EventJournal, JournalHandler
from .recorder import RECORDER, FlightRecorder, default_forensics_dir
from .watchdog import INFLIGHT, InflightTable, Watchdog

__all__ = [
    "BUNDLE_SCHEMA",
    "EventJournal",
    "FlightRecorder",
    "INFLIGHT",
    "InflightTable",
    "JOURNAL",
    "JournalHandler",
    "RECORDER",
    "Watchdog",
    "default_forensics_dir",
    "latest_bundle",
    "prune_bundles",
    "write_bundle",
]
