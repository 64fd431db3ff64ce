"""The port's chain on its SQLite database: a dev chain over
``SqliteDbController`` runs past finalization, and the blocks it archived
read back, from the same file opened again, with the JAX chain's bytes."""

import asyncio

from lodestar_tpu.chain.bls_pool import BlsBatchPool as JPool
from lodestar_tpu.config.chain_config import ChainConfig as JChainConfig
from lodestar_tpu.crypto.bls.native_verifier import FastBlsVerifier as JFast
from lodestar_tpu.db import BeaconDb as JBeaconDb, SqliteDbController as JSqlite
from lodestar_tpu.node.dev_chain import DevChain as JDevChain
from lodestar_tpu.params import MINIMAL as J_MINIMAL
from lodestar_tpu.state_transition.upgrade import block_types as j_block_types
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool as PPool
from lodestar_tpu_torch.config.chain_config import ChainConfig as PChainConfig
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier as PFast
from lodestar_tpu_torch.db import BeaconDb, SqliteDbController
from lodestar_tpu_torch.db.schema import Bucket, encode_key
from lodestar_tpu_torch.node.dev_chain import DevChain as PDevChain
from lodestar_tpu_torch.params import MINIMAL as P_MINIMAL
from lodestar_tpu_torch.state_transition.upgrade import block_types as p_block_types

N_VALIDATORS = 32
CFG = dict(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
           MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N_VALIDATORS)
N_SLOTS = 4 * P_MINIMAL.SLOTS_PER_EPOCH + 2


def _run(dev_cls, pool, preset, cfg, db):
    async def main():
        dev = dev_cls(preset, cfg, N_VALIDATORS, pool, db=db)
        await dev.run(N_SLOTS)
        pool.close()
        return dev.chain

    return asyncio.run(main())


def test_archived_blocks_read_back_from_sqlite_equal_the_jax_chains(tmp_path):
    path = str(tmp_path / "port.sqlite")
    pchain = _run(PDevChain, PPool(PFast(), max_buffer_wait=0.005), P_MINIMAL,
                  PChainConfig(**CFG), BeaconDb(P_MINIMAL, SqliteDbController(path)))
    jchain = _run(JDevChain, JPool(JFast(), max_buffer_wait=0.005), J_MINIMAL,
                  JChainConfig(**CFG), JBeaconDb(J_MINIMAL, JSqlite(str(tmp_path / "jax.sqlite"))))
    finalized = pchain.fork_choice.store.finalized_checkpoint.epoch
    assert finalized >= 1 and finalized == jchain.fork_choice.store.finalized_checkpoint.epoch
    assert pchain.head_root == jchain.head_root
    end = finalized * P_MINIMAL.SLOTS_PER_EPOCH + 1
    pchain.db.close()

    reopened = BeaconDb(P_MINIMAL, SqliteDbController(path))
    port_blocks = list(reopened.archived_blocks_by_slot_range(0, end))
    jax_blocks = list(jchain.db.archived_blocks_by_slot_range(0, end))
    assert len(port_blocks) == len(jax_blocks) >= P_MINIMAL.SLOTS_PER_EPOCH
    for pb, jb in zip(port_blocks, jax_blocks):
        pt = p_block_types(P_MINIMAL, pb.message)
        jt = j_block_types(J_MINIMAL, jb.message)
        assert pt.SignedBeaconBlock.serialize(pb) == jt.SignedBeaconBlock.serialize(jb)
        root = pt.BeaconBlock.hash_tree_root(pb.message)
        assert root == jt.BeaconBlock.hash_tree_root(jb.message)
        # the root index leads back to the archived block, and the hot
        # bucket no longer holds it
        back = reopened.get_archived_block_by_root(root)
        assert pt.SignedBeaconBlock.serialize(back) == pt.SignedBeaconBlock.serialize(pb)
        assert reopened.db.get(encode_key(Bucket.block, root)) is None
    # the raw rows of both files are the same bytes
    prows = list(reopened.db.entries())
    jrows = list(jchain.db.db.entries())
    assert [k for k, _ in prows] == [k for k, _ in jrows]
    assert prows == jrows
    reopened.close()
    jchain.db.close()
