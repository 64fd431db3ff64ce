"""A rehearsal of chip_smoke's phase 18 on the CPU: its range-sync driver
(18a: node A alone over the host's C verifier, node B syncing over the
loopback through its pool) at 16 validators, with the port's
``FastBlsVerifier`` standing in for the card's verifier, reaching the head
that the JAX package's dev chain reaches over the same slots; and the
phase's helpers (the validators' split, the pool's batch record by lane,
percentiles, the log-line clock).  The gossip driver (18b) is held against
the JAX sim in ``test_torch_sim_multinode.py`` and the commands' driver
(18c) in ``test_torch_cli_node.py``.  The phase itself needs a card."""

import asyncio
import os
import sys

import pytest

from lodestar_tpu.chain.bls_pool import BlsBatchPool as JPool
from lodestar_tpu.config.chain_config import ChainConfig as JChainConfig
from lodestar_tpu.crypto.bls.native_verifier import FastBlsVerifier as JFast
from lodestar_tpu.node.dev_chain import DevChain as JDevChain
from lodestar_tpu.params import MINIMAL as J_MINIMAL
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N = 16


def jax_head(n_slots: int) -> str:
    async def run():
        pool = JPool(JFast(), max_buffer_wait=0.005)
        cfg = JChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                           MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N,
                           ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)
        dev = JDevChain(J_MINIMAL, cfg, N, pool)
        await dev.run(n_slots)
        pool.close()
        return dev.chain.head_root.hex()

    return asyncio.run(run())


def test_range_sync_driver_reaches_the_jax_chains_head():
    started = []
    out = asyncio.run(chip_smoke.sync_pair(FastBlsVerifier(), N, chip_smoke.NET_SYNC_SLOTS,
                                           on_start=lambda: started.append(True)))
    assert started == [True]
    assert out["synced"] and out["imported"] == chip_smoke.NET_SYNC_SLOTS
    assert out["head"] == out["want_head"] == jax_head(chip_smoke.NET_SYNC_SLOTS)
    # one pool job a segment, each on the block-proposal lane
    assert len(out["batches"]) == out["segments"] == len(out["segment_wait_s"]) >= 2
    assert {lanes for lanes, _ in out["batches"]} == {"block_proposal"}


def test_the_phases_split_and_helpers():
    assert [(r.start, r.stop) for r in chip_smoke.sim_split(128)] == [(0, 43), (43, 86),
                                                                       (86, 128)]
    assert [(r.start, r.stop) for r in chip_smoke.sim_split(16)] == [(0, 6), (6, 11), (11, 16)]
    p = chip_smoke.percentiles([0.3, 0.1, 0.2])
    assert p == dict(n=3, p50=0.2, p95=pytest.approx(0.29))
    assert chip_smoke.percentiles([]) == dict(n=0, p50=None, p95=None)


def test_pool_batches_record_each_batchs_lanes_and_sets():
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.verifier import SignatureSetPriority

    class Count:
        def verify_signature_sets(self, sets):
            return True

    async def run():
        pool = BlsBatchPool(Count(), max_buffer_wait=0.05)
        record = chip_smoke.PoolBatches(pool)
        jobs = [pool.verify_signature_sets([object()] * 2, priority=SignatureSetPriority.BLOCK_PROPOSAL),
                pool.verify_signature_sets([object()], batchable=True,
                                           priority=SignatureSetPriority.UNAGGREGATED)]
        assert all(await asyncio.gather(*jobs))
        pool.close()
        return record

    record = asyncio.run(run())
    assert sum(n for _, n in record.batches) == 3
    assert record.by_lane_and_bucket(lambda n: 4) == {
        f"{lanes}@4": 1 for lanes, _ in record.batches}


def test_log_seconds_reads_the_commands_text_lines(tmp_path):
    path = tmp_path / "x.err"
    path.write_text("2026-10-18 10:11:31,796 INFO lodestar_tpu_torch.cli: bls warmup: 3 buckets\n"
                    "2026-10-18 10:11:33,296 INFO lodestar_tpu_torch.cli: synced 40 blocks\n")
    t0, line0 = chip_smoke.log_seconds(str(path), "bls warmup:")
    t1, line1 = chip_smoke.log_seconds(str(path), "synced ")
    assert t1 - t0 == pytest.approx(1.5) and line1.endswith("synced 40 blocks")
    assert chip_smoke.log_seconds(str(path), "absent") == (None, None)
