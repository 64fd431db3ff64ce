"""Per-fork SSZ type schemas (phase0 / altair / bellatrix).

Reference: packages/types/src/{phase0,altair,bellatrix}/sszTypes.ts and the
allForks helpers (packages/types/src/sszTypes.ts:1-8).  Types are built
from a Preset (sizes differ between mainnet and minimal, exactly like the
reference's params-driven type construction) and memoized per preset.

Usage:
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.types import get_types
    t = get_types(MINIMAL)
    t.phase0.BeaconState.default()
"""

from .schemas import ForkTypes, TypeRegistry, get_types  # noqa: F401
