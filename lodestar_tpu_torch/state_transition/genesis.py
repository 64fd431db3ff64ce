"""Genesis state construction: interop (deterministic keys) + eth1 path.

Reference: packages/state-transition/src/util/genesis.ts
(initializeBeaconStateFromEth1) and util/interop.ts / the dev command's
interop state (cli/src/cmds/dev/).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from ..config.chain_config import ChainConfig
from ..crypto.bls.api import interop_secret_key
from ..params import (
    BLS_WITHDRAWAL_PREFIX,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    Preset,
)
from ..ssz import Fields
from ..types import get_types
from .epoch_context import EpochContext
from .misc import is_active_validator


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _genesis_scaffold(p: Preset, cfg: ChainConfig, genesis_time: int, randao_fill: bytes):
    """The state skeleton both genesis paths share: fork record, default-
    body latest_block_header, filled randao mixes."""
    t = get_types(p).phase0
    state = t.BeaconState.default()
    state.genesis_time = genesis_time
    state.fork = Fields(
        previous_version=cfg.GENESIS_FORK_VERSION,
        current_version=cfg.GENESIS_FORK_VERSION,
        epoch=GENESIS_EPOCH,
    )
    body_root = t.BeaconBlockBody.hash_tree_root(t.BeaconBlockBody.default())
    state.latest_block_header = Fields(
        slot=0,
        proposer_index=0,
        parent_root=b"\x00" * 32,
        state_root=b"\x00" * 32,
        body_root=body_root,
    )
    state.randao_mixes = [randao_fill] * p.EPOCHS_PER_HISTORICAL_VECTOR
    return state


def interop_genesis_state(
    p: Preset,
    cfg: ChainConfig,
    validator_count: int,
    genesis_time: int = 1_578_009_600,
):
    """Deterministic genesis with interop keys, all validators active at
    genesis — the dev-chain / sim-test starting point (reference:
    getDevBeaconNode interop genesis, SURVEY §4.4)."""
    state = _genesis_scaffold(p, cfg, genesis_time, b"\x42" * 32)

    for i in range(validator_count):
        sk = interop_secret_key(i)
        pubkey = sk.to_public_key().to_bytes()
        wc = BLS_WITHDRAWAL_PREFIX + _sha(pubkey)[1:]
        state.validators.append(
            Fields(
                pubkey=pubkey,
                withdrawal_credentials=wc,
                effective_balance=p.MAX_EFFECTIVE_BALANCE,
                slashed=False,
                activation_eligibility_epoch=GENESIS_EPOCH,
                activation_epoch=GENESIS_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        state.balances.append(p.MAX_EFFECTIVE_BALANCE)

    state.genesis_validators_root = _genesis_validators_root(p, state)
    state.eth1_data = Fields(
        deposit_root=b"\x00" * 32,
        deposit_count=validator_count,
        block_hash=b"\x01" * 32,
    )
    state.eth1_deposit_index = validator_count
    return state


def initialize_beacon_state_from_eth1(
    p: Preset,
    cfg: ChainConfig,
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
):
    """Spec initialize_beacon_state_from_eth1 (reference
    state-transition/src/util/genesis.ts initializeBeaconStateFromEth1):
    replay the deposit list with full merkle-proof verification against
    an incrementally-updated deposit root, then activate every validator
    that reached MAX_EFFECTIVE_BALANCE."""
    from types import SimpleNamespace

    from ..eth1.tracker import DepositTree
    from .block import process_deposit

    t = get_types(p).phase0
    state = _genesis_scaffold(
        p, cfg, eth1_timestamp + cfg.GENESIS_DELAY, bytes(eth1_block_hash)
    )
    state.eth1_data = Fields(
        deposit_root=b"\x00" * 32,
        deposit_count=len(deposits),
        block_hash=bytes(eth1_block_hash),
    )

    # apply_deposit needs only the pubkey->index map (with .set) and the
    # index2pubkey list of the growing registry — a shim stands in for
    # the full EpochContext during genesis replay
    class _PkMap(dict):
        def set(self, k, v):
            self[k] = v

    ctx = SimpleNamespace(pubkey2index=_PkMap(), index2pubkey=[])
    # per spec, the deposit root for proof-checking deposit i covers the
    # first i+1 leaves; the incremental tree keeps replay O(n log n)
    tree = DepositTree()
    for deposit in deposits:
        tree.push(t.DepositData.hash_tree_root(deposit.data))
        state.eth1_data.deposit_root = tree.root()
        process_deposit(p, cfg, ctx, state, deposit)

    # process activations
    for index, v in enumerate(state.validators):
        balance = state.balances[index]
        eff = min(balance - balance % p.EFFECTIVE_BALANCE_INCREMENT, p.MAX_EFFECTIVE_BALANCE)
        v.effective_balance = eff
        if eff == p.MAX_EFFECTIVE_BALANCE:
            v.activation_eligibility_epoch = GENESIS_EPOCH
            v.activation_epoch = GENESIS_EPOCH
    state.genesis_validators_root = _genesis_validators_root(p, state)
    return state


def _genesis_validators_root(p: Preset, state) -> bytes:
    t = get_types(p).phase0
    from ..ssz import List as SszList

    vtype = SszList(t.Validator, p.VALIDATOR_REGISTRY_LIMIT)
    return vtype.hash_tree_root(list(state.validators))


def is_valid_genesis_state(p: Preset, cfg: ChainConfig, state) -> bool:
    if state.genesis_time < cfg.MIN_GENESIS_TIME:
        return False
    active = sum(1 for v in state.validators if is_active_validator(v, GENESIS_EPOCH))
    return active >= cfg.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
