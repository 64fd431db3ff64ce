"""Preset (compile-time-ish) spec constants.

Reference: packages/params/src/presets/{mainnet,minimal}/{phase0,altair,bellatrix}.ts
and packages/params/src/index.ts (non-preset constants).

A ``Preset`` is a frozen dataclass: explicit, hashable (usable as a jit static
arg), and cheap to thread through pure functions — the counterpart of the
reference's module-level frozen singleton.
"""

from __future__ import annotations

import dataclasses
import os

UINT64_MAX = 2**64 - 1

# ---------------------------------------------------------------------------
# Non-preset constants (packages/params/src/index.ts)
# ---------------------------------------------------------------------------

GENESIS_SLOT = 0
GENESIS_EPOCH = 0
# The reference uses JS Infinity; we use uint64 max per consensus spec.
FAR_FUTURE_EPOCH = UINT64_MAX
BASE_REWARDS_PER_EPOCH = 4
DEPOSIT_CONTRACT_TREE_DEPTH = 32
JUSTIFICATION_BITS_LENGTH = 4

BLS_WITHDRAWAL_PREFIX = bytes([0])
ETH1_ADDRESS_WITHDRAWAL_PREFIX = bytes([1])

DOMAIN_BEACON_PROPOSER = bytes([0, 0, 0, 0])
DOMAIN_BEACON_ATTESTER = bytes([1, 0, 0, 0])
DOMAIN_RANDAO = bytes([2, 0, 0, 0])
DOMAIN_DEPOSIT = bytes([3, 0, 0, 0])
DOMAIN_VOLUNTARY_EXIT = bytes([4, 0, 0, 0])
DOMAIN_SELECTION_PROOF = bytes([5, 0, 0, 0])
DOMAIN_AGGREGATE_AND_PROOF = bytes([6, 0, 0, 0])
DOMAIN_SYNC_COMMITTEE = bytes([7, 0, 0, 0])
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = bytes([8, 0, 0, 0])
DOMAIN_CONTRIBUTION_AND_PROOF = bytes([9, 0, 0, 0])
DOMAIN_APPLICATION_BUILDER = bytes([0, 0, 0, 1])

TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = (TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT)

TARGET_AGGREGATORS_PER_COMMITTEE = 16
RANDOM_SUBNETS_PER_VALIDATOR = 1
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION = 256
ATTESTATION_SUBNET_COUNT = 64
TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 16
SYNC_COMMITTEE_SUBNET_COUNT = 4
MAX_REQUEST_BLOCKS = 1024

GENESIS_GAS_LIMIT = 30_000_000
GENESIS_BASE_FEE_PER_GAS = 1_000_000_000

# Altair light-client generalized indices
FINALIZED_ROOT_GINDEX = 105
FINALIZED_ROOT_DEPTH = 6
FINALIZED_ROOT_INDEX = 41
NEXT_SYNC_COMMITTEE_GINDEX = 55
NEXT_SYNC_COMMITTEE_DEPTH = 5
NEXT_SYNC_COMMITTEE_INDEX = 23

SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY = 128
INTERVALS_PER_SLOT = 3


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Preset:
    """One preset = phase0 + altair + bellatrix preset values."""

    name: str

    # phase0 — misc
    MAX_COMMITTEES_PER_SLOT: int
    TARGET_COMMITTEE_SIZE: int
    MAX_VALIDATORS_PER_COMMITTEE: int
    SHUFFLE_ROUND_COUNT: int
    HYSTERESIS_QUOTIENT: int = 4
    HYSTERESIS_DOWNWARD_MULTIPLIER: int = 1
    HYSTERESIS_UPWARD_MULTIPLIER: int = 5
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED: int = 8

    # phase0 — gwei
    MIN_DEPOSIT_AMOUNT: int = 1_000_000_000
    MAX_EFFECTIVE_BALANCE: int = 32_000_000_000
    EFFECTIVE_BALANCE_INCREMENT: int = 1_000_000_000

    # phase0 — time
    MIN_ATTESTATION_INCLUSION_DELAY: int = 1
    SLOTS_PER_EPOCH: int = 32
    MIN_SEED_LOOKAHEAD: int = 1
    MAX_SEED_LOOKAHEAD: int = 4
    EPOCHS_PER_ETH1_VOTING_PERIOD: int = 64
    SLOTS_PER_HISTORICAL_ROOT: int = 8192
    MIN_EPOCHS_TO_INACTIVITY_PENALTY: int = 4

    # phase0 — state list lengths
    EPOCHS_PER_HISTORICAL_VECTOR: int = 65536
    EPOCHS_PER_SLASHINGS_VECTOR: int = 8192
    HISTORICAL_ROOTS_LIMIT: int = 16_777_216
    VALIDATOR_REGISTRY_LIMIT: int = 1_099_511_627_776

    # phase0 — rewards & penalties
    BASE_REWARD_FACTOR: int = 64
    WHISTLEBLOWER_REWARD_QUOTIENT: int = 512
    PROPOSER_REWARD_QUOTIENT: int = 8
    INACTIVITY_PENALTY_QUOTIENT: int = 67_108_864
    MIN_SLASHING_PENALTY_QUOTIENT: int = 128
    PROPORTIONAL_SLASHING_MULTIPLIER: int = 1

    # phase0 — max operations per block
    MAX_PROPOSER_SLASHINGS: int = 16
    MAX_ATTESTER_SLASHINGS: int = 2
    MAX_ATTESTATIONS: int = 128
    MAX_DEPOSITS: int = 16
    MAX_VOLUNTARY_EXITS: int = 16

    # altair
    SYNC_COMMITTEE_SIZE: int = 512
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD: int = 256
    INACTIVITY_PENALTY_QUOTIENT_ALTAIR: int = 50_331_648
    MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR: int = 64
    PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR: int = 2
    MIN_SYNC_COMMITTEE_PARTICIPANTS: int = 1
    UPDATE_TIMEOUT: int = 8192

    # bellatrix
    INACTIVITY_PENALTY_QUOTIENT_BELLATRIX: int = 16_777_216
    MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX: int = 32
    PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX: int = 3
    MAX_BYTES_PER_TRANSACTION: int = 1_073_741_824
    MAX_TRANSACTIONS_PER_PAYLOAD: int = 1_048_576
    BYTES_PER_LOGS_BLOOM: int = 256
    MAX_EXTRA_DATA_BYTES: int = 32

    @property
    def SYNC_COMMITTEE_SUBNET_SIZE(self) -> int:
        return self.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT


MAINNET = Preset(
    name="mainnet",
    MAX_COMMITTEES_PER_SLOT=64,
    TARGET_COMMITTEE_SIZE=128,
    MAX_VALIDATORS_PER_COMMITTEE=2048,
    SHUFFLE_ROUND_COUNT=90,
)

MINIMAL = Preset(
    name="minimal",
    MAX_COMMITTEES_PER_SLOT=4,
    TARGET_COMMITTEE_SIZE=4,
    MAX_VALIDATORS_PER_COMMITTEE=2048,
    SHUFFLE_ROUND_COUNT=10,
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED=2,
    SLOTS_PER_EPOCH=8,
    EPOCHS_PER_ETH1_VOTING_PERIOD=4,
    SLOTS_PER_HISTORICAL_ROOT=64,
    EPOCHS_PER_HISTORICAL_VECTOR=64,
    EPOCHS_PER_SLASHINGS_VECTOR=64,
    INACTIVITY_PENALTY_QUOTIENT=33_554_432,
    MIN_SLASHING_PENALTY_QUOTIENT=64,
    PROPORTIONAL_SLASHING_MULTIPLIER=2,
    SYNC_COMMITTEE_SIZE=32,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
    UPDATE_TIMEOUT=64,
)

# Gnosis chain: mainnet-shaped state with a 5s slot cadence
# (packages/params/src/presets/gnosis.ts — identical preset values to
# mainnet; the chain differences live in the ChainConfig: SECONDS_PER_SLOT,
# fork versions, deposit contract).  A distinct instance so `name`
# round-trips through config/SSZ context checks.
GNOSIS = Preset(
    name="gnosis",
    MAX_COMMITTEES_PER_SLOT=64,
    TARGET_COMMITTEE_SIZE=128,
    MAX_VALIDATORS_PER_COMMITTEE=2048,
    SHUFFLE_ROUND_COUNT=90,
)

_PRESETS = {"mainnet": MAINNET, "minimal": MINIMAL, "gnosis": GNOSIS}


def active_preset() -> Preset:
    """Preset selected via LODESTAR_PRESET env var (default mainnet).

    Mirrors packages/params/src/presetName.ts behavior.
    """
    name = os.environ.get("LODESTAR_PRESET", "mainnet")
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; known: {sorted(_PRESETS)}") from None
