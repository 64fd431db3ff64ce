"""Fee-recipient registrations from prepareBeaconProposer.

Reference: packages/beacon-node/src/chain/beaconProposerCache.ts — VCs
re-send their proposer preparations every epoch; entries expire after
PROPOSER_PRESERVE_EPOCHS so a disconnected VC's fee recipient stops
overriding the node default.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

PROPOSER_PRESERVE_EPOCHS = 2


class BeaconProposerCache:
    def __init__(self, default_fee_recipient: bytes = b"\x00" * 20):
        self.default_fee_recipient = default_fee_recipient
        self._entries: Dict[int, Tuple[int, bytes]] = {}  # index -> (epoch, recipient)

    def add(self, epoch: int, validator_index: int, fee_recipient: bytes) -> None:
        self._entries[int(validator_index)] = (int(epoch), bytes(fee_recipient))

    def prune(self, current_epoch: int) -> None:
        cutoff = current_epoch - PROPOSER_PRESERVE_EPOCHS
        self._entries = {
            i: (e, r) for i, (e, r) in self._entries.items() if e >= cutoff
        }

    def get(self, proposer_index: int) -> bytes:
        entry = self._entries.get(int(proposer_index))
        return entry[1] if entry is not None else self.default_fee_recipient

    def get_or_none(self, proposer_index: int) -> Optional[bytes]:
        entry = self._entries.get(int(proposer_index))
        return entry[1] if entry is not None else None
