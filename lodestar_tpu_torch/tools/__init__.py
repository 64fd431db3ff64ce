"""The port's operations harnesses, each run as ``python -m
lodestar_tpu_torch.tools.<name>``:

- ``firehose``       sustained mainnet-shaped load on a ``BlsBatchPool``
                     over the card's verifier, with full drop accounting;
- ``chaos_campaign`` every fault class through the port's seams: each
                     fault diagnosable, no verdict lost, the executor
                     re-admitted;
- ``prewarm``        the prewarm farm: fills the kernel-library store
                     under a farm lock, or verifies and sweeps it;
- ``inspect_bundle`` validates and summarizes a diagnostic bundle;
- ``meshscope``      per-batch attribution and the scaling-loss breakdown
                     of a trace dump;
- ``perf_report``    the trend and regression tripwires over
                     ``chip_smoke.py``'s run records;
- ``tier1_budget``   the tier-1 suite's wall time against its cap, its
                     movers and slowest tests.

Importing a module here starts no card and builds nothing."""
