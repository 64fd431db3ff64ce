"""The port's multi-node sim against the JAX package's: three nodes in the
line A-B-C (``tests/test_sim_multinode.py``'s first case: 16 interop
validators split 0-5, 6-10, 11-15, 26 slots, manual clocks), every block
and every single-bit attestation over the wire, each proposer packing the
aggregates of its pool.  The port runs ``chip_smoke.three_node_sim``, the
driver of chip_smoke's phase 18b (here over the port's ``FastBlsVerifier``
where the card's run has ``TorchBlsVerifier``): its head at every slot,
and the final head root and justified and finalized checkpoints, equal the
JAX sim's.  The eight-node mesh case (``test_sim_multinode.py``'s second)
runs on the port too, marked slow: over two minutes on one core."""

import asyncio
import os
import sys

import pytest

from lodestar_tpu.params import MINIMAL as J_MINIMAL
from lodestar_tpu.ssz import Fields as JFields
from lodestar_tpu.state_transition import compute_epoch_at_slot as j_epoch_at
from lodestar_tpu.state_transition import process_slots as j_process_slots
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

import test_sim_multinode as jsim  # noqa: E402  (the JAX sim's nodes and helpers)

N_VALIDATORS = 16
N_SLOTS = 3 * 8 + 2
WAIT_S = 60.0


def jax_sim(n_slots: int = N_SLOTS) -> dict:
    """The JAX test's three-node loop, keeping each slot's head."""

    async def main():
        nodes = [jsim.SimNode(i, jsim.SUBSETS[i]) for i in range(3)]
        p0 = await nodes[0].net.listen(0)
        p1 = await nodes[1].net.listen(0)
        await nodes[1].net.connect("127.0.0.1", p0)
        await nodes[2].net.connect("127.0.0.1", p1)
        loop = asyncio.get_running_loop()

        async def wait(pred, what):
            deadline = loop.time() + WAIT_S
            while not pred():
                assert loop.time() < deadline, what
                await asyncio.sleep(0.01)

        heads = []
        for slot in range(1, n_slots + 1):
            for n in nodes:
                n.dev.clock.set_slot(slot)
            state = jsim.clone_state(J_MINIMAL, nodes[0].chain.head_state())
            proposer = j_process_slots(J_MINIMAL, jsim.CFG, state, slot).get_beacon_proposer(slot)
            owner = next(n for n in nodes if proposer in n.owned)
            att_slot = slot - J_MINIMAL.MIN_ATTESTATION_INCLUSION_DELAY
            aggs = jsim._pool_aggregates(owner, att_slot) if att_slot >= 1 else []
            randao = owner.dev._sign_randao(state, proposer, j_epoch_at(J_MINIMAL, slot))
            block, _ = owner.chain.produce_block(slot, randao,
                                                 attestations=aggs[:J_MINIMAL.MAX_ATTESTATIONS])
            signed = JFields(message=block,
                             signature=owner.dev._sign_block(state, block, proposer))
            root = await owner.chain.process_block(signed)
            await owner.net.publish_block(signed)
            await wait(lambda: all(n.chain.head_root == root for n in nodes), f"slot {slot}")
            heads.append(root.hex())
            expected = 0
            for n in nodes:
                for att, subnet in jsim._attest_subset(n, slot):
                    n.chain.att_pool.add(att)
                    await n.net.publish_attestation(att, subnet=subnet)
                    expected += 1
            await wait(lambda: all(
                sum(len(g.bits_and_sigs) for g in n.chain.att_pool._by_slot.get(slot, {}).values())
                >= expected for n in nodes), f"votes of slot {slot}")
        st = nodes[0].chain.head_state()
        out = dict(head=nodes[0].chain.head_root.hex(),
                   justified=[int(st.current_justified_checkpoint.epoch),
                              bytes(st.current_justified_checkpoint.root).hex()],
                   finalized=[int(st.finalized_checkpoint.epoch),
                              bytes(st.finalized_checkpoint.root).hex()])
        for n in nodes:
            await n.close()
        return dict(outcome=out, heads=heads)

    return asyncio.run(main())


def test_three_nodes_over_gossip_equal_the_jax_sim():
    assert [list(r) for r in chip_smoke.sim_split(N_VALIDATORS)] == [
        list(s) for s in jsim.SUBSETS]
    verifier = FastBlsVerifier()
    port = asyncio.run(chip_smoke.three_node_sim([verifier] * 3, N_VALIDATORS, N_SLOTS))
    assert port["outcome"]["justified"][0] >= 1
    assert port["votes"] == N_SLOTS * N_VALIDATORS // 8
    for node in port["nodes"]:
        assert node["att_failed"] == 0 and node["blocks"] == N_SLOTS
        # every vote of the other two nodes crossed the wire to this one
        assert node["att_validated"] == port["votes"] - node["own_votes"] > 0
    ref = jax_sim()
    assert port["heads"] == ref["heads"]
    assert port["outcome"] == ref["outcome"]


@pytest.mark.slow
def test_eight_nodes_reach_justification_over_the_port_mesh():
    """test_sim_multinode's mesh case on the port: 8 fully-connected
    nodes, 2 validators each, heartbeats running; the mesh degree stays
    within D_HIGH and every node justifies."""
    from lodestar_tpu_torch.network.gossip import GOSSIP_D_HIGH
    from lodestar_tpu_torch.params import MINIMAL
    from lodestar_tpu_torch.ssz import Fields
    from lodestar_tpu_torch.state_transition import (
        clone_state, compute_epoch_at_slot, process_slots)

    async def main():
        n_nodes = 8
        verifier = FastBlsVerifier()
        nodes = [chip_smoke.SimNode(i, range(2 * i, 2 * i + 2), N_VALIDATORS, verifier)
                 for i in range(n_nodes)]
        ports = [await n.net.listen(0) for n in nodes]
        for i in range(n_nodes):
            for j in range(i):
                await nodes[i].net.connect("127.0.0.1", ports[j])
        for n in nodes:
            await n.net.router.heartbeat()
        for slot in range(1, N_SLOTS + 1):
            for n in nodes:
                n.dev.clock.set_slot(slot)
            state = clone_state(MINIMAL, nodes[0].chain.head_state())
            proposer = process_slots(MINIMAL, nodes[0].chain.cfg, state,
                                     slot).get_beacon_proposer(slot)
            owner = next(n for n in nodes if proposer in n.owned)
            att_slot = slot - MINIMAL.MIN_ATTESTATION_INCLUSION_DELAY
            aggs = []
            if att_slot >= 1:
                for data_root in list(owner.chain.att_pool._by_slot.get(att_slot, {})):
                    agg = owner.chain.att_pool.get_aggregate(att_slot, data_root)
                    if agg is not None:
                        aggs.append(agg)
            randao = owner.dev._sign_randao(state, proposer, compute_epoch_at_slot(MINIMAL, slot))
            block, _ = owner.chain.produce_block(slot, randao,
                                                 attestations=aggs[:MINIMAL.MAX_ATTESTATIONS])
            signed = Fields(message=block, signature=owner.dev._sign_block(state, block, proposer))
            root = await owner.chain.process_block(signed)
            await owner.net.publish_block(signed)
            await chip_smoke.wait_until(lambda: all(n.chain.head_root == root for n in nodes),
                                        f"slot {slot}", WAIT_S)
            expected = 0
            for n in nodes:
                for att, subnet in chip_smoke.attest_subset(n, slot):
                    n.chain.att_pool.add(att)
                    await n.net.publish_attestation(att, subnet=subnet)
                    expected += 1
            await chip_smoke.wait_until(
                lambda: all(chip_smoke.pool_votes(n, slot) >= expected for n in nodes),
                f"votes of slot {slot}", WAIT_S)
            for n in nodes:
                for members in n.net.router.mesh.values():
                    assert len(members) <= GOSSIP_D_HIGH
        for n in nodes:
            assert n.chain.head_state().current_justified_checkpoint.epoch >= 1
        assert len({n.chain.head_root for n in nodes}) == 1
        for n in nodes:
            await n.close()

    asyncio.run(main())
