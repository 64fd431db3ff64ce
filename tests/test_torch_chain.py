"""The port's dev chain against the JAX package's: ``DevChain`` over each
package's ``BlsBatchPool`` and ``FastBlsVerifier``, 32 interop validators,
the minimal preset, Altair at epoch 1 and Bellatrix at epoch 2 (the schedule
of ``tests/test_fork_transition.py``), six epochs and two slots, in
lockstep.  Slot by slot the heads, the head states' roots, the justified
and finalized checkpoints and every pool batch's set count are equal; at
the end the JAX chain's head state crosses to the port as SSZ bytes and a
port chain anchored on it imports the JAX chain's next block.  Every
comparison is by bytes or by root, with no tolerance."""

import asyncio

from lodestar_tpu.chain.bls_pool import BlsBatchPool as JPool
from lodestar_tpu.config.chain_config import ChainConfig as JChainConfig
from lodestar_tpu.crypto.bls.native_verifier import FastBlsVerifier as JFast
from lodestar_tpu.node.dev_chain import DevChain as JDevChain
from lodestar_tpu.params import MINIMAL as J_MINIMAL
from lodestar_tpu.state_transition.upgrade import state_types as j_state_types
from lodestar_tpu_torch.chain.beacon_chain import BeaconChain
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool as PPool
from lodestar_tpu_torch.config.chain_config import ChainConfig as PChainConfig
from lodestar_tpu_torch.config.fork_config import ForkName
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier as PFast
from lodestar_tpu_torch.crypto.bls.verifier import PyBlsVerifier
from lodestar_tpu_torch.metrics import create_metrics
from lodestar_tpu_torch.node.dev_chain import DevChain as PDevChain
from lodestar_tpu_torch.params import MINIMAL as P_MINIMAL
from lodestar_tpu_torch.state_transition.upgrade import state_fork_name, state_types
from lodestar_tpu_torch.types import get_types

N_VALIDATORS = 32
SCHEDULE = dict(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N_VALIDATORS, ALTAIR_FORK_EPOCH=1,
                BELLATRIX_FORK_EPOCH=2)
N_SLOTS = 6 * P_MINIMAL.SLOTS_PER_EPOCH + 2


class JRecording(JFast):
    """The JAX verifier, recording each batch's set count."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def verify_signature_sets(self, sets):
        self.batches.append(len(sets))
        return super().verify_signature_sets(sets)


class PRecording(PFast):
    """The port's verifier, recording each batch's set count."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def verify_signature_sets(self, sets):
        self.batches.append(len(sets))
        return super().verify_signature_sets(sets)


def _summary(chain, types_of):
    state = chain.head_state()
    return dict(
        head=chain.head_root,
        state_root=types_of(chain.p, state).BeaconState.hash_tree_root(state),
        justified=(int(state.current_justified_checkpoint.epoch),
                   bytes(state.current_justified_checkpoint.root)),
        finalized=(int(state.finalized_checkpoint.epoch), bytes(state.finalized_checkpoint.root)),
        fork_choice_finalized=(chain.fork_choice.store.finalized_checkpoint.epoch,
                               chain.fork_choice.store.finalized_checkpoint.root),
    )


def test_port_chain_equals_the_jax_chain_slot_by_slot_across_two_forks():
    async def main():
        jv, pv = JRecording(), PRecording()
        jpool, ppool = JPool(jv, max_buffer_wait=0.005), PPool(pv, max_buffer_wait=0.005)
        jdev = JDevChain(J_MINIMAL, JChainConfig(**SCHEDULE), N_VALIDATORS, jpool)
        pdev = PDevChain(P_MINIMAL, PChainConfig(**SCHEDULE), N_VALIDATORS, ppool)
        assert _summary(pdev.chain, state_types) == _summary(jdev.chain, j_state_types)
        for slot in range(1, N_SLOTS + 1):
            # DevChain.run's loop body, one slot at a time on both chains
            for dev in (jdev, pdev):
                await dev.advance_slot(slot)
                await dev.chain.prepare_scheduler.prepare(slot + 1)
            assert _summary(pdev.chain, state_types) == _summary(jdev.chain, j_state_types), slot
            assert pv.batches == jv.batches, slot
        state = pdev.chain.head_state()
        assert state_fork_name(state) == ForkName.bellatrix
        assert state.current_justified_checkpoint.epoch >= 4
        assert state.finalized_checkpoint.epoch >= 3
        assert len(pv.batches) >= N_SLOTS and pv.sets_verified == sum(pv.batches)

        # the JAX head state crosses as bytes: a port chain anchored on it
        # imports the JAX chain's next block, at the JAX chain's root
        jstate = jdev.chain.head_state()
        blob = j_state_types(J_MINIMAL, jstate).BeaconState.serialize(jstate)
        t = get_types(P_MINIMAL).bellatrix.BeaconState
        anchor = t.deserialize(blob)
        assert t.hash_tree_root(anchor) == j_state_types(
            J_MINIMAL, jstate).BeaconState.hash_tree_root(jstate)
        follower = BeaconChain(P_MINIMAL, PChainConfig(**SCHEDULE), anchor, ppool)
        assert follower.head_root == jdev.chain.head_root
        signed = await jdev.produce_and_import_block(N_SLOTS + 1)
        assert await follower.process_block(signed) == jdev.chain.head_root
        jpool.close()
        ppool.close()

    asyncio.run(main())


class CountingVerifier(PyBlsVerifier):
    def __init__(self):
        super().__init__()
        self.dispatches = 0
        self.sets_seen = 0

    def verify_signature_sets(self, sets):
        self.dispatches += 1
        self.sets_seen += len(sets)
        return super().verify_signature_sets(sets)


CHAIN_METRICS = (
    "lodestar_head_slot", "lodestar_finalized_epoch", "lodestar_clock_slot",
    "lodestar_block_processing_seconds", "lodestar_state_transition_seconds",
    "lodestar_epoch_transition_seconds", "lodestar_state_cache_size",
    "lodestar_op_pool_size", "lodestar_db_op_seconds", "lodestar_db_ops_total",
    "lodestar_bls_pool_dispatches_total",
)


def test_phase0_chain_through_the_bigint_verifier_with_the_chain_metrics():
    """tests/test_dev_chain.py's shape on the port: one epoch and two slots
    of phase0 over a counting ``PyBlsVerifier``, every block's sets one pool
    job, and the chain's metrics exposed under the JAX names."""
    cfg = PChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                       MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N_VALIDATORS)

    async def main():
        verifier = CountingVerifier()
        metrics = create_metrics()
        pool = PPool(verifier, max_buffer_wait=0.005, metrics=metrics)
        dev = PDevChain(P_MINIMAL, cfg, N_VALIDATORS, pool, metrics=metrics)
        n_slots = P_MINIMAL.SLOTS_PER_EPOCH + 2
        await dev.run(n_slots)
        chain = dev.chain
        assert chain.fork_choice.get_block(chain.head_root).slot == n_slots
        assert verifier.dispatches >= n_slots and verifier.sets_seen >= 2 * n_slots
        assert any(v.next_epoch > 0 for v in chain.fork_choice.votes)
        anchor = chain.fork_choice.proto.nodes[0]
        assert chain.fork_choice.is_descendant(anchor.block_root, chain.head_root)
        text = metrics.reg.expose().decode()
        missing = [name for name in CHAIN_METRICS if name not in text]
        assert missing == []
        assert f"lodestar_head_slot {float(n_slots)}" in text
        pool.close()

    asyncio.run(main())
