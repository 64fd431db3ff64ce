"""Beacon chain state transition (phase0-first) + caches + signature sets.

Reference: packages/state-transition (src/stateTransition.ts:19 entry,
src/cache/epochContext.ts:78 caches, src/signatureSets/index.ts:23
collectors).  See SURVEY.md §2.2.
"""

from .domain import (  # noqa: F401
    compute_domain,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
    get_domain,
)
from .epoch_context import EpochContext, EpochShuffling, PubkeyIndexMap  # noqa: F401
from .genesis import interop_genesis_state, is_valid_genesis_state  # noqa: F401
from .misc import (  # noqa: F401
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
)
from .signature_sets import get_block_signature_sets  # noqa: F401
from .state_transition import (  # noqa: F401
    StateTransitionError,
    clone_state,
    process_slot,
    process_slots,
    state_transition,
)
