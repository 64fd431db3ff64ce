"""Proto-array LMD-GHOST fork choice.

Reference: packages/fork-choice (SURVEY §2.3).
"""

from .fork_choice import Checkpoint, ForkChoice, ForkChoiceError, ForkChoiceStore  # noqa: F401
from .proto_array import (  # noqa: F401
    ProtoArray,
    ProtoArrayError,
    ProtoNode,
    VoteTracker,
    compute_deltas,
)
