"""Deposit-construction helpers for tests and vector generation.

Builds spec-shaped deposits (signed DepositData + 33-element sparse-tree
proof) from interop keys — the input side of
initialize_beacon_state_from_eth1 and the genesis vector generator.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

from ..config.chain_config import ChainConfig
from ..crypto.bls.api import interop_secret_key
from ..params import BLS_WITHDRAWAL_PREFIX, DOMAIN_DEPOSIT, Preset
from ..params.presets import DEPOSIT_CONTRACT_TREE_DEPTH
from ..ssz import Fields
from ..ssz.core import ZERO_HASHES
from ..state_transition import compute_domain, compute_signing_root
from ..types import get_types


def make_deposit_data(p: Preset, cfg: ChainConfig, i: int, amount: Optional[int] = None) -> Fields:
    t = get_types(p).phase0
    sk = interop_secret_key(i)
    pubkey = sk.to_public_key().to_bytes()
    wc = BLS_WITHDRAWAL_PREFIX + hashlib.sha256(pubkey).digest()[1:]
    amount = amount if amount is not None else p.MAX_EFFECTIVE_BALANCE
    msg = Fields(pubkey=pubkey, withdrawal_credentials=wc, amount=amount)
    domain = compute_domain(p, DOMAIN_DEPOSIT, cfg.GENESIS_FORK_VERSION)
    root = compute_signing_root(p, t.DepositMessage, msg, domain)
    return Fields(
        pubkey=pubkey, withdrawal_credentials=wc, amount=amount,
        signature=sk.sign(root).to_bytes(),
    )


def deposit_proof(leaves: List[bytes], index: int, total: int) -> List[bytes]:
    """32-level sparse-tree branch for leaf `index` over the first
    `total` leaves, plus the little-endian length mix-in leaf — the shape
    spec process_deposit verifies (DEPOSIT_CONTRACT_TREE_DEPTH + 1)."""
    layer = list(leaves[:total])
    branch = []
    pos = index
    for d in range(DEPOSIT_CONTRACT_TREE_DEPTH):
        sib = pos ^ 1
        branch.append(layer[sib] if sib < len(layer) else ZERO_HASHES[d])
        nxt = []
        for i in range(0, len(layer), 2):
            left = layer[i]
            right = layer[i + 1] if i + 1 < len(layer) else ZERO_HASHES[d]
            nxt.append(hashlib.sha256(left + right).digest())
        layer = nxt or [ZERO_HASHES[d + 1]]
        pos //= 2
    branch.append(total.to_bytes(32, "little"))
    return branch


def build_deposits(
    p: Preset, cfg: ChainConfig, n: int, amounts: Optional[Dict[int, int]] = None
) -> List[Fields]:
    t = get_types(p).phase0
    datas = [make_deposit_data(p, cfg, i, (amounts or {}).get(i)) for i in range(n)]
    leaves = [t.DepositData.hash_tree_root(d) for d in datas]
    return [
        Fields(proof=deposit_proof(leaves, i, i + 1), data=datas[i]) for i in range(n)
    ]
