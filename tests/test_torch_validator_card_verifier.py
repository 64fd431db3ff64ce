"""The validator client's duties through the card's verifier, on the CPU:
a node whose pool runs ``TorchBlsVerifier`` (the split fused program's
plain versions, bucket 4), as ``chip_smoke.py`` phase 19 drives it on the
card.  The port's client, holding the keys of slot 1's and slot 2's
proposers and of one attester of slot 1, drives two phase0 slots over
REST: a block, a single attestation and an aggregate in slot 1, a block
carrying that vote in slot 2, each its own batch on its own lane.  The
heads and block bytes equal the same two slots on a node over
``FastBlsVerifier`` (exact).  About 65 s on one core: four bucket-4
verdicts of the plain versions."""

import asyncio

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.api import ApiClient, RestApiServer
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.chain.handlers import GossipHandlers
from lodestar_tpu_torch.config.chain_config import ChainConfig
from lodestar_tpu_torch.crypto.bls.api import interop_secret_key
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority
from lodestar_tpu_torch.node.dev_chain import DevChain
from lodestar_tpu_torch.params import MINIMAL
from lodestar_tpu_torch.types import get_types
from lodestar_tpu_torch.validator import ValidatorClient, ValidatorStore

N = 16
CFG = ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                  MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=2**64 - 1,
                  BELLATRIX_FORK_EPOCH=2**64 - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The verifier runs its program's plain versions: one intra-op
    thread, as the other program-running files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _two_slots(verifier) -> dict:
    async def run():
        pool = BlsBatchPool(verifier, max_buffer_wait=0.005)
        lanes = []
        verify = pool.verify_signature_sets

        async def recording(sets, batchable=True, priority=None, deadline=None):
            lanes.append((SignatureSetPriority(priority).name if priority is not None
                          else None, len(sets)))
            return await verify(sets, batchable=batchable, priority=priority, deadline=deadline)

        pool.verify_signature_sets = recording
        dev = DevChain(MINIMAL, CFG, N, pool)
        rest = RestApiServer(MINIMAL, dev.chain)
        rest.gossip_handlers = GossipHandlers(dev.chain)
        api = ApiClient("127.0.0.1", await rest.listen(0))
        proposers = [int(d["validator_index"])
                     for d in (await api.get("/eth/v1/validator/duties/proposer/0"))["data"]
                     if int(d["slot"]) in (1, 2)]
        duties = (await api.post("/eth/v1/validator/duties/attester/0",
                                 [str(i) for i in range(N)]))["data"]
        attester = next(int(d["validator_index"]) for d in duties
                        if int(d["slot"]) == 1 and int(d["validator_index"]) not in proposers)
        keys = {i: interop_secret_key(i) for i in (*proposers, attester)}
        gvr = bytes(dev.chain.genesis_state.genesis_validators_root)
        vc = ValidatorClient(MINIMAL, CFG, ValidatorStore(MINIMAL, CFG, keys,
                                                          genesis_validators_root=gvr), api)
        t = get_types(MINIMAL).phase0
        heads, blocks = [], []
        for slot in (1, 2):
            dev.clock.set_slot(slot)
            await vc.run_slot(slot)
            heads.append(dev.chain.head_root.hex())
            blocks.append(t.SignedBeaconBlock.serialize(
                dev.chain.get_block_by_root(dev.chain.head_root)))
        await rest.close()
        pool.close()
        return dict(heads=heads, blocks=blocks, lanes=lanes,
                    votes=len(t.SignedBeaconBlock.deserialize(blocks[1]).message.body.attestations))

    return asyncio.run(run())


def test_two_slots_of_duties_through_the_cards_verifier_on_the_cpu():
    verifier = TorchBlsVerifier(device="cpu", buckets=(4,), rng=np.random.default_rng(19))
    assert verifier.fused and verifier.host_final_exp  # the split fused default
    got = _two_slots(verifier)
    assert verifier.dispatches == 4 and verifier.sets_verified == 2 + 1 + 3 + 3
    assert got["lanes"] == [("BLOCK_PROPOSAL", 2), ("UNAGGREGATED", 1), ("AGGREGATE", 3),
                            ("BLOCK_PROPOSAL", 3)]
    assert got["votes"] == 1
    assert got == _two_slots(FastBlsVerifier())
