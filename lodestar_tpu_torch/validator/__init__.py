"""Validator client: duty services + signing with slashing protection.

Reference surface: packages/validator/src/ (validator.ts:60 orchestrator,
services/attestation.ts:22, services/block.ts, slashingProtection/index.ts:30
with the EIP-3076 interchange format).
"""

from .client import ValidatorClient  # noqa: F401
from .header_tracker import ChainHeaderTracker  # noqa: F401
from .slashing_protection import SlashingProtection, SlashingError  # noqa: F401
from .store import ValidatorStore  # noqa: F401
