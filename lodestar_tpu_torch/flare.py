"""flare: beacon-chain ops / debugging CLI.

Reference: packages/flare/src/cmds/ (self-slash-proposer,
self-slash-attester — testnet tooling that deliberately slashes a range
of owned validators through the beacon API), plus db inspection commands
our BeaconDb makes cheap.

A slashing is signed under the fork version that the node's own fork
schedule gives its epoch (the headers' slot's epoch for a proposer
slashing), so that it verifies when the block carrying it is imported.
The JAX package's copy signs under the preset's published chain config
(genesis version ``0x00000001`` on minimal) and the genesis fork for
every proposer slashing, which an interop chain's block import refuses.

Usage:
    python -m lodestar_tpu_torch.flare self-slash-proposer --server http://... \
        --index-start 0 --count 2 [--interop]
    python -m lodestar_tpu_torch.flare self-slash-attester ...
    python -m lodestar_tpu_torch.flare dump-block --db beacon.db --root 0x...
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from .api.client import ApiClient
from .api.serde import to_json
from .crypto.bls.api import interop_secret_key
from .params import DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, Preset
from .params.presets import MAINNET, MINIMAL
from .ssz import Fields
from .state_transition import compute_domain, compute_signing_root
from .types import get_types


def _preset(name: str) -> Preset:
    return MINIMAL if name == "minimal" else MAINNET


def _secret_keys(args):
    """Interop key derivation for the index range (util/deriveSecretKeys.ts
    — we support the interop schedule; EIP-2335 keystores go through the
    account CLI instead)."""
    return {
        i: interop_secret_key(i)
        for i in range(args.index_start, args.index_start + args.count)
    }


def _api(server: str) -> ApiClient:
    from urllib.parse import urlparse

    u = urlparse(server)
    return ApiClient(u.hostname or "127.0.0.1", u.port or 9596)


async def _genesis_validators_root(api: ApiClient) -> bytes:
    g = await api.get("/eth/v1/beacon/genesis")
    return bytes.fromhex(g["data"]["genesis_validators_root"][2:])


async def _fork_version(api: ApiClient, epoch: int) -> bytes:
    """The fork version of ``epoch`` in the node's own schedule
    (``/eth/v1/config/fork_schedule``), so that a slashing verifies on the
    chain it is sent to, whatever its fork versions and epochs."""
    forks = (await api.get("/eth/v1/config/fork_schedule"))["data"]
    version = forks[0]["current_version"]
    for fork in forks:
        if int(fork["epoch"]) <= epoch:
            version = fork["current_version"]
    return bytes.fromhex(version[2:])


async def self_slash_proposer(args) -> int:
    """Submit a ProposerSlashing for each owned validator: two signed
    headers at the same slot with different body roots
    (selfSlashProposer.ts handler), signed under the fork of the headers'
    epoch."""
    p = _preset(args.preset)
    t = get_types(p).phase0
    api = _api(args.server)
    gvr = await _genesis_validators_root(api)
    fork_version = await _fork_version(api, args.slot // p.SLOTS_PER_EPOCH)
    domain = compute_domain(p, DOMAIN_BEACON_PROPOSER, fork_version, gvr)
    sent = 0
    for index, sk in _secret_keys(args).items():
        headers = []
        for body_root_seed in (b"\x01", b"\x02"):
            header = Fields(
                slot=args.slot,
                proposer_index=index,
                parent_root=b"\x00" * 32,
                state_root=b"\x00" * 32,
                body_root=body_root_seed * 32,
            )
            root = compute_signing_root(p, t.BeaconBlockHeader, header, domain)
            headers.append(Fields(message=header, signature=sk.sign(root).to_bytes()))
        slashing = Fields(signed_header_1=headers[0], signed_header_2=headers[1])
        await api.post("/eth/v1/beacon/pool/proposer_slashings", to_json(slashing))
        sent += 1
        print(f"submitted ProposerSlashing for validator {index}")
    return sent


async def self_slash_attester(args) -> int:
    """Submit an AttesterSlashing per batch of owned validators: two
    IndexedAttestations with the same target but different data (a double
    vote, selfSlashAttester.ts handler)."""
    p = _preset(args.preset)
    t = get_types(p).phase0
    api = _api(args.server)
    gvr = await _genesis_validators_root(api)
    keys = _secret_keys(args)
    epoch = args.epoch
    fork_version = await _fork_version(api, epoch)
    domain = compute_domain(p, DOMAIN_BEACON_ATTESTER, fork_version, gvr)
    indices = sorted(keys)
    atts = []
    for seed in (b"\x01", b"\x02"):
        data = Fields(
            slot=epoch * p.SLOTS_PER_EPOCH,
            index=0,
            beacon_block_root=seed * 32,
            source=Fields(epoch=max(0, epoch - 1), root=b"\x00" * 32),
            target=Fields(epoch=epoch, root=b"\x00" * 32),
        )
        root = compute_signing_root(p, t.AttestationData, data, domain)
        from .crypto.bls.api import aggregate_signatures

        sig = aggregate_signatures([keys[i].sign(root) for i in indices])
        atts.append(
            Fields(attesting_indices=indices, data=data, signature=sig.to_bytes())
        )
    slashing = Fields(attestation_1=atts[0], attestation_2=atts[1])
    await api.post("/eth/v1/beacon/pool/attester_slashings", to_json(slashing))
    print(f"submitted AttesterSlashing for validators {indices}")
    return 1


def dump_block(args) -> int:
    """Print a stored block as JSON (db inspection; no reference analog —
    flare's util surface grown the obvious way for our BeaconDb)."""
    from .db.beacon import BeaconDb

    p = _preset(args.preset)
    from .db.controller import SqliteDbController

    db = BeaconDb(p, SqliteDbController(args.db))
    root = bytes.fromhex(args.root[2:] if args.root.startswith("0x") else args.root)
    blk = db.block.get(root) or db.get_archived_block_by_root(root)
    if blk is None:
        print("block not found", file=sys.stderr)
        return 1
    print(json.dumps(to_json(blk), indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flare", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--server", default="http://127.0.0.1:9596")
        sp.add_argument("--preset", default="minimal", choices=["minimal", "mainnet"])
        sp.add_argument("--index-start", type=int, default=0)
        sp.add_argument("--count", type=int, default=1)

    sp = sub.add_parser("self-slash-proposer", help="double-proposal slashing for owned keys")
    common(sp)
    sp.add_argument("--slot", type=int, default=0)

    sa = sub.add_parser("self-slash-attester", help="double-vote slashing for owned keys")
    common(sa)
    sa.add_argument("--epoch", type=int, default=0)

    dbp = sub.add_parser("dump-block", help="print a stored block as JSON")
    dbp.add_argument("--db", required=True)
    dbp.add_argument("--root", required=True)
    dbp.add_argument("--preset", default="minimal", choices=["minimal", "mainnet"])

    args = ap.parse_args(argv)
    if args.cmd == "self-slash-proposer":
        return 0 if asyncio.run(self_slash_proposer(args)) else 1
    if args.cmd == "self-slash-attester":
        return 0 if asyncio.run(self_slash_attester(args)) else 1
    if args.cmd == "dump-block":
        return dump_block(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
