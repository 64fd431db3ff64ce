"""Fork schedule helpers and fork digests.

Reference: packages/config/src/forkConfig/index.ts (getForkInfo/getForkName/
getForkSeq) and packages/config/src/beaconConfig.ts (fork digest caches keyed
by genesisValidatorsRoot).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Dict, List

from .chain_config import ChainConfig


class ForkName(str, enum.Enum):
    phase0 = "phase0"
    altair = "altair"
    bellatrix = "bellatrix"


FORK_SEQ = {ForkName.phase0: 0, ForkName.altair: 1, ForkName.bellatrix: 2}


@dataclasses.dataclass(frozen=True)
class ForkInfo:
    name: ForkName
    seq: int
    epoch: int
    version: bytes
    prev_version: bytes
    prev_fork_name: ForkName


class ForkConfig:
    """Fork schedule derived from a ChainConfig.

    Reference: packages/config/src/forkConfig/index.ts:18-104.
    """

    def __init__(self, cfg: ChainConfig):
        self.chain = cfg
        phase0 = ForkInfo(
            name=ForkName.phase0,
            seq=0,
            epoch=0,
            version=cfg.GENESIS_FORK_VERSION,
            prev_version=cfg.GENESIS_FORK_VERSION,
            prev_fork_name=ForkName.phase0,
        )
        altair = ForkInfo(
            name=ForkName.altair,
            seq=1,
            epoch=cfg.ALTAIR_FORK_EPOCH,
            version=cfg.ALTAIR_FORK_VERSION,
            prev_version=cfg.GENESIS_FORK_VERSION,
            prev_fork_name=ForkName.phase0,
        )
        bellatrix = ForkInfo(
            name=ForkName.bellatrix,
            seq=2,
            epoch=cfg.BELLATRIX_FORK_EPOCH,
            version=cfg.BELLATRIX_FORK_VERSION,
            prev_version=cfg.ALTAIR_FORK_VERSION,
            prev_fork_name=ForkName.altair,
        )
        self.forks: Dict[ForkName, ForkInfo] = {
            ForkName.phase0: phase0,
            ForkName.altair: altair,
            ForkName.bellatrix: bellatrix,
        }
        # Scheduled forks only (far-future = unscheduled, never selected —
        # matches the reference's `epoch >= Infinity` always-false semantics),
        # ascending by activation epoch; phase0 (epoch 0) always first.
        from ..params.presets import UINT64_MAX

        self.forks_ascending: List[ForkInfo] = sorted(
            (f for f in self.forks.values() if f.epoch < UINT64_MAX or f.seq == 0),
            key=lambda f: (f.epoch, f.seq),
        )

    def get_fork_info(self, slot: int, slots_per_epoch: int) -> ForkInfo:
        return self.get_fork_info_at_epoch(slot // slots_per_epoch)

    def get_fork_info_at_epoch(self, epoch: int) -> ForkInfo:
        current = self.forks[ForkName.phase0]
        for fork in self.forks_ascending:
            if epoch >= fork.epoch:
                current = fork
        return current

    def get_fork_version(self, epoch: int) -> bytes:
        return self.get_fork_info_at_epoch(epoch).version


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData(current_version, genesis_validators_root)).

    ForkData is two 32-byte leaves: the 4-byte version right-padded and the
    root; its hash_tree_root is a single sha256 of their concatenation.
    Spec: compute_fork_data_root; reference uses ssz.phase0.ForkData.
    """
    leaf0 = current_version + b"\x00" * 28
    return hashlib.sha256(leaf0 + genesis_validators_root).digest()


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


class BeaconConfig(ForkConfig):
    """ForkConfig + genesisValidatorsRoot-dependent fork-digest caches.

    Reference: packages/config/src/beaconConfig.ts (createBeaconConfig,
    forkName2ForkDigest / forkDigest2ForkName caches).
    """

    def __init__(self, cfg: ChainConfig, genesis_validators_root: bytes):
        super().__init__(cfg)
        self.genesis_validators_root = genesis_validators_root
        self._digest_by_fork: Dict[ForkName, bytes] = {}
        self._fork_by_digest: Dict[bytes, ForkName] = {}
        for fork in self.forks.values():
            digest = compute_fork_digest(fork.version, genesis_validators_root)
            self._digest_by_fork[fork.name] = digest
            self._fork_by_digest.setdefault(digest, fork.name)

    def fork_name_to_digest(self, fork: ForkName) -> bytes:
        return self._digest_by_fork[fork]

    def digest_to_fork_name(self, digest: bytes) -> ForkName:
        try:
            return self._fork_by_digest[bytes(digest)]
        except KeyError:
            raise ValueError(f"unknown fork digest {bytes(digest).hex()}") from None


def create_beacon_config(cfg: ChainConfig, genesis_validators_root: bytes) -> BeaconConfig:
    return BeaconConfig(cfg, genesis_validators_root)
