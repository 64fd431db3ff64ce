"""The chain through the card's verifier, on the CPU: ``TorchBlsVerifier``
(the split fused program's plain versions, buckets 4 and 8) behind the
port's ``BlsBatchPool``, as ``chip_smoke.py`` phase 17 drives it on the
card.  A range-sync segment of two phase0 blocks at 16 validators is one
batch and reaches the head of a ``FastBlsVerifier`` chain; a block with an
altered signature raises ``BlockError`` (its two sets verified at bucket
4, twice: the pool retries a failed job on its own).  About 55 s on one
core."""

import asyncio

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.chain.beacon_chain import BlockError
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.config.chain_config import ChainConfig
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.node.dev_chain import DevChain
from lodestar_tpu_torch.params import MINIMAL
from lodestar_tpu_torch.ssz import Fields

CFG = ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                  MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16, ALTAIR_FORK_EPOCH=2**64 - 1,
                  BELLATRIX_FORK_EPOCH=2**64 - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The verifier runs its program's plain versions: one intra-op
    thread, as the other program-running files pin it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host_segment(n_slots):
    """The producer's blocks and head, over the host C verifier."""
    async def run():
        pool = BlsBatchPool(FastBlsVerifier(), max_buffer_wait=0.005)
        producer = DevChain(MINIMAL, CFG, 16, pool)
        seg = []
        for slot in range(1, 1 + n_slots):
            seg.append(producer.chain.get_block_by_root(await producer.advance_slot(slot)))
        pool.close()
        return seg, producer.chain.head_root

    return asyncio.run(run())


def test_segment_and_bad_block_through_the_cards_verifier_on_the_cpu():
    seg, host_head = _host_segment(2)

    async def run():
        verifier = TorchBlsVerifier(device="cpu", buckets=(4, 8), rng=np.random.default_rng(18))
        assert verifier.fused and verifier.host_final_exp  # the split fused default
        pool = BlsBatchPool(verifier, max_buffer_wait=0.005)
        consumer = DevChain(MINIMAL, CFG, 16, pool)
        assert await consumer.chain.process_chain_segment(seg) == 2
        assert verifier.dispatches == 1 and pool.batch_retries == 0
        assert consumer.chain.head_root == host_head

        # a second chain: block 1 with another block's signature
        bad = Fields(message=seg[0].message, signature=bytes(seg[1].signature))
        other = DevChain(MINIMAL, CFG, 16, pool)
        with pytest.raises(BlockError):
            await other.chain.process_block(bad)
        assert not other.chain.fork_choice.has_block(consumer.chain.head_root)
        assert verifier.dispatches == 3 and pool.batch_retries == 1
        pool.close()
        verifier.close()

    asyncio.run(run())
