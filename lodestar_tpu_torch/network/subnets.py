"""Attestation/sync-committee subnet services + metadata controller.

Reference: packages/beacon-node/src/network/subnets/attnetsService.ts:31
(long-lived random subnets with epoch-based rotation + short-lived
committee subscriptions for aggregation duties, ENR/metadata updates,
shouldProcess gate), subnets/syncnetsService.ts:18, network/metadata.ts
(seq-numbered metadata served over reqresp).

This stack floods gossip to all peers, so "subscription" here governs
what the node ADVERTISES (metadata/ENR bitfields) and which subnets'
messages it validates eagerly (should_process) — the same observable
surface the reference's mesh joins produce.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Set

from ..params import Preset
from ..params.presets import (
    ATTESTATION_SUBNET_COUNT,
    SYNC_COMMITTEE_SUBNET_COUNT,
)
from ..utils.logger import get_logger

logger = get_logger("subnets")

RANDOM_SUBNETS_PER_VALIDATOR = 1
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION = 256


class MetadataController:
    """seq-numbered metadata (network/metadata.ts): every attnets/syncnets
    change bumps seq_number so peers know to re-fetch."""

    def __init__(self):
        self.seq_number = 0
        self.attnets = [False] * ATTESTATION_SUBNET_COUNT
        self.syncnets = [False] * SYNC_COMMITTEE_SUBNET_COUNT

    def update_attnets(self, bits: List[bool]) -> None:
        if bits != self.attnets:
            self.attnets = list(bits)
            self.seq_number += 1

    def update_syncnets(self, bits: List[bool]) -> None:
        if bits != self.syncnets:
            self.syncnets = list(bits)
            self.seq_number += 1


class AttnetsService:
    """Long-lived random subnets (one per tracked validator, rotated every
    ~256 epochs at a per-validator offset) + short-lived committee
    subscriptions from aggregation duties (attnetsService.ts:31,100-130)."""

    def __init__(self, preset: Preset, metadata: MetadataController, node_seed: bytes = b""):
        self.p = preset
        self.metadata = metadata
        self.node_seed = node_seed or bytes(8)
        self.tracked_validators: Set[int] = set()
        # subnet -> expiry slot for short-lived committee subscriptions
        self._committee_subs: Dict[int, int] = {}
        self._current_epoch = 0

    # -- inputs ---------------------------------------------------------------

    def add_validator(self, validator_index: int) -> None:
        self.tracked_validators.add(int(validator_index))
        self._refresh_metadata()

    def add_committee_subscription(self, subnet: int, until_slot: int) -> None:
        """Short-lived duty subscription (beacon_committee_subscriptions
        API route -> prepareBeaconCommitteeSubnet)."""
        cur = self._committee_subs.get(subnet, 0)
        self._committee_subs[subnet] = max(cur, until_slot)
        self._refresh_metadata()

    def on_slot(self, slot: int) -> None:
        epoch = slot // self.p.SLOTS_PER_EPOCH
        changed = epoch != self._current_epoch
        self._current_epoch = epoch
        expired = [s for s, until in self._committee_subs.items() if until < slot]
        for s in expired:
            del self._committee_subs[s]
        if changed or expired:
            self._refresh_metadata()

    # -- subnet math ----------------------------------------------------------

    def _random_subnet_for(self, validator_index: int, epoch: int) -> int:
        """Deterministic rotation: stable for EPOCHS_PER_RANDOM_SUBNET_
        SUBSCRIPTION epochs, phase-shifted per validator so the fleet's
        rotations spread out (the reference randomizes lifetimes; a seeded
        hash gives the same distribution reproducibly)."""
        period = EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION
        offset = validator_index % period
        window = (epoch + offset) // period
        digest = hashlib.sha256(
            self.node_seed + validator_index.to_bytes(8, "little") + window.to_bytes(8, "little")
        ).digest()
        return int.from_bytes(digest[:8], "little") % ATTESTATION_SUBNET_COUNT

    def active_subnets(self) -> Set[int]:
        out = {
            self._random_subnet_for(vi, self._current_epoch)
            for vi in self.tracked_validators
        }
        out.update(self._committee_subs.keys())
        return out

    def should_process(self, subnet: int) -> bool:
        """attnetsService.ts shouldProcess: eagerly validate only the
        subnets we serve (others still forward via the router dedup)."""
        return subnet in self.active_subnets()

    def _refresh_metadata(self) -> None:
        bits = [False] * ATTESTATION_SUBNET_COUNT
        for s in self.active_subnets():
            bits[s] = True
        self.metadata.update_attnets(bits)


class SyncnetsService:
    """Sync-committee subnets from duties (syncnetsService.ts:18)."""

    def __init__(self, preset: Preset, metadata: MetadataController):
        self.p = preset
        self.metadata = metadata
        self._subs: Dict[int, int] = {}  # subnet -> expiry slot

    def add_subscription(self, subnet: int, until_slot: int) -> None:
        cur = self._subs.get(subnet, 0)
        self._subs[subnet] = max(cur, until_slot)
        self._refresh()

    def on_slot(self, slot: int) -> None:
        expired = [s for s, until in self._subs.items() if until < slot]
        for s in expired:
            del self._subs[s]
        if expired:
            self._refresh()

    def active_subnets(self) -> Set[int]:
        return set(self._subs.keys())

    def _refresh(self) -> None:
        bits = [False] * SYNC_COMMITTEE_SUBNET_COUNT
        for s in self._subs:
            bits[s] = True
        self.metadata.update_syncnets(bits)
