"""Runtime chain configuration and fork schedule.

Reference: packages/config (src/chainConfig/types.ts, presets/{mainnet,minimal}.ts,
src/forkConfig/index.ts).
"""

from .chain_config import ChainConfig, MAINNET_CHAIN_CONFIG, MINIMAL_CHAIN_CONFIG
from .fork_config import ForkInfo, ForkName, ForkConfig, BeaconConfig, create_beacon_config

__all__ = [
    "ChainConfig",
    "MAINNET_CHAIN_CONFIG",
    "MINIMAL_CHAIN_CONFIG",
    "ForkInfo",
    "ForkName",
    "ForkConfig",
    "BeaconConfig",
    "create_beacon_config",
]
