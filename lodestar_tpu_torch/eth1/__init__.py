"""Eth1 data tracking for deposits + eth1Data votes.

Reference: packages/beacon-node/src/eth1/ — eth1DepositDataTracker.ts:46
(deposit log follower + eth1Data vote production), eth1MergeBlockTracker
(bellatrix TTD search), provider/eth1Provider.ts (JSON-RPC source,
abstracted here behind Eth1ProviderMock for images without an EL).
"""

from .tracker import Eth1DepositDataTracker, Eth1ProviderMock  # noqa: F401
