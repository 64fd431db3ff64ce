"""Per-network runtime chain config.

Reference: packages/config/src/chainConfig/{types.ts,presets/mainnet.ts,
presets/minimal.ts,networks/mainnet.ts}.
"""

from __future__ import annotations

import dataclasses

from ..params.presets import UINT64_MAX


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    PRESET_BASE: str

    # Transition (the merge)
    TERMINAL_TOTAL_DIFFICULTY: int = 2**256 - 1
    TERMINAL_BLOCK_HASH: bytes = b"\x00" * 32
    TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH: int = UINT64_MAX

    # Genesis
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT: int = 16384
    MIN_GENESIS_TIME: int = 1606824000
    GENESIS_FORK_VERSION: bytes = bytes.fromhex("00000000")
    GENESIS_DELAY: int = 604800

    # Fork schedule
    ALTAIR_FORK_VERSION: bytes = bytes.fromhex("01000000")
    ALTAIR_FORK_EPOCH: int = UINT64_MAX
    BELLATRIX_FORK_VERSION: bytes = bytes.fromhex("02000000")
    BELLATRIX_FORK_EPOCH: int = UINT64_MAX

    # Time parameters
    SECONDS_PER_SLOT: int = 12
    SECONDS_PER_ETH1_BLOCK: int = 14
    MIN_VALIDATOR_WITHDRAWABILITY_DELAY: int = 256
    SHARD_COMMITTEE_PERIOD: int = 256
    ETH1_FOLLOW_DISTANCE: int = 2048

    # Validator cycle
    INACTIVITY_SCORE_BIAS: int = 4
    INACTIVITY_SCORE_RECOVERY_RATE: int = 16
    EJECTION_BALANCE: int = 16_000_000_000
    MIN_PER_EPOCH_CHURN_LIMIT: int = 4
    CHURN_LIMIT_QUOTIENT: int = 65536
    PROPOSER_SCORE_BOOST: int = 40

    # Deposit contract
    DEPOSIT_CHAIN_ID: int = 1
    DEPOSIT_NETWORK_ID: int = 1
    DEPOSIT_CONTRACT_ADDRESS: bytes = bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa")


MAINNET_CHAIN_CONFIG = ChainConfig(
    PRESET_BASE="mainnet",
    ALTAIR_FORK_EPOCH=74240,
)

MINIMAL_CHAIN_CONFIG = ChainConfig(
    PRESET_BASE="minimal",
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=64,
    MIN_GENESIS_TIME=1578009600,
    GENESIS_FORK_VERSION=bytes.fromhex("00000001"),
    GENESIS_DELAY=300,
    ALTAIR_FORK_VERSION=bytes.fromhex("01000001"),
    ALTAIR_FORK_EPOCH=74240,
    BELLATRIX_FORK_VERSION=bytes.fromhex("02000001"),
    SECONDS_PER_SLOT=6,
    SHARD_COMMITTEE_PERIOD=64,
    ETH1_FOLLOW_DISTANCE=16,
    CHURN_LIMIT_QUOTIENT=32,
    DEPOSIT_CHAIN_ID=5,
    DEPOSIT_NETWORK_ID=5,
    DEPOSIT_CONTRACT_ADDRESS=bytes.fromhex("1234567890123456789012345678901234567890"),
)
