"""A JAX node and a port node on one loopback, with the same genesis (16
interop validators, phase0): the port node range-syncs from a JAX node to
its head root and a JAX node from a port node; a block and a single-bit
attestation that one publishes over gossip are imported and pooled by the
other, both ways.  What crosses is SSZ bytes on the port's wire: this is
what shows that the port speaks the reference's.  Every wait is bounded."""

import asyncio
import importlib

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
WAIT_S = 30.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


class Node:
    def __init__(self, pkg: str):
        self.pkg = pkg
        cfg = mod(pkg, "config.chain_config").ChainConfig(
            PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
            MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N,
            ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)
        self.pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
            mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)
        self.p = mod(pkg, "params").MINIMAL
        self.dev = mod(pkg, "node.dev_chain").DevChain(self.p, cfg, N, self.pool)
        self.chain = self.dev.chain
        self.net = mod(pkg, "network").Network(
            self.p, self.chain, mod(pkg, "chain.handlers").GossipHandlers(self.chain))

    async def close(self):
        await self.net.close()
        self.pool.close()


async def poll(pred, what: str):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + WAIT_S
    while not pred():
        assert loop.time() < deadline, f"{what} not reached in {WAIT_S} s"
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_range_sync_across_the_packages(server, client):
    async def main():
        a, b = Node(server), Node(client)
        await a.dev.run(2 * a.p.SLOTS_PER_EPOCH + 4)
        port = await a.net.listen(0)
        peer = await asyncio.wait_for(b.net.connect("127.0.0.1", port), WAIT_S)
        assert peer.status.head_slot == a.chain.head_state().slot
        assert bytes(peer.status.head_root) == a.chain.head_root
        assert await asyncio.wait_for(peer.reqresp.ping(11), WAIT_S) == 11
        sync = mod(client, "sync").RangeSync(b.p, b.chain, b.net.peer_manager)
        imported = await asyncio.wait_for(sync.run_to_head(), WAIT_S)
        assert sync.state == mod(client, "sync").SyncState.synced
        assert imported == 2 * a.p.SLOTS_PER_EPOCH + 4
        assert b.chain.head_root == a.chain.head_root
        sa, sb = a.chain.head_state(), b.chain.head_state()
        ta = mod(server, "types").get_types(a.p).phase0.BeaconState
        tb = mod(client, "types").get_types(b.p).phase0.BeaconState
        assert ta.hash_tree_root(sa) == tb.hash_tree_root(sb)
        assert tb.serialize(sb) == ta.serialize(sa)
        await b.close()
        await a.close()

    asyncio.run(main())


def _single_attestation(node: Node, slot: int, validator: int):
    """The single-bit gossip attestation of ``validator`` at ``slot`` and its
    subnet (tests/test_sim_multinode.py's shape)."""
    pkg = node.pkg
    st = mod(pkg, "state_transition")
    dom = mod(pkg, "state_transition.domain")
    Fields = mod(pkg, "ssz").Fields
    t = mod(pkg, "types").get_types(node.p).phase0
    state = st.clone_state(node.p, node.chain.head_state())
    ctx = st.process_slots(node.p, node.chain.cfg, state, max(slot, state.slot))
    epoch = st.compute_epoch_at_slot(node.p, slot)
    domain = dom.get_domain(node.p, state, mod(pkg, "params").DOMAIN_BEACON_ATTESTER, epoch)
    committees = ctx.get_committee_count_per_slot(epoch)
    boundary = st.compute_start_slot_at_epoch(node.p, epoch)
    target = node.chain.head_root if boundary >= state.slot else bytes(
        state.block_roots[boundary % node.p.SLOTS_PER_HISTORICAL_ROOT])
    for index in range(committees):
        committee = [int(v) for v in ctx.get_beacon_committee(slot, index)]
        if validator not in committee:
            continue
        data = Fields(slot=slot, index=index, beacon_block_root=node.chain.head_root,
                      source=state.current_justified_checkpoint,
                      target=Fields(epoch=epoch, root=target))
        root = dom.compute_signing_root(node.p, t.AttestationData, data, domain)
        bits = [v == validator for v in committee]
        subnet = (committees * (slot % node.p.SLOTS_PER_EPOCH) + index) % 64
        return Fields(aggregation_bits=bits, data=data,
                      signature=node.dev.keys[validator].sign(root).to_bytes()), subnet
    return None


def _committee_members(node: Node, slot: int):
    st = mod(node.pkg, "state_transition")
    state = st.clone_state(node.p, node.chain.head_state())
    ctx = st.process_slots(node.p, node.chain.cfg, state, max(slot, state.slot))
    epoch = st.compute_epoch_at_slot(node.p, slot)
    return [int(v) for i in range(ctx.get_committee_count_per_slot(epoch))
            for v in ctx.get_beacon_committee(slot, i)]


def _votes(node: Node, slot: int) -> int:
    return sum(len(g.bits_and_sigs) for g in node.chain.att_pool._by_slot.get(slot, {}).values())


@pytest.mark.parametrize("publisher,receiver", [("jax", "port"), ("port", "jax")])
def test_gossip_block_and_attestation_across_the_packages(publisher, receiver):
    async def main():
        a, b = Node(publisher), Node(receiver)
        port = await a.net.listen(0)
        await asyncio.wait_for(b.net.connect("127.0.0.1", port), WAIT_S)
        for slot in (1, 2):
            signed = await a.dev.produce_and_import_block(slot)
            b.dev.clock.set_slot(slot)
            a.dev.clock.set_slot(slot)
            assert await a.net.publish_block(signed) == 1
            await poll(lambda: b.chain.head_root == a.chain.head_root, f"block {slot}")
        validator = _committee_members(a, 2)[0]
        att, subnet = _single_attestation(a, 2, validator)
        a.chain.att_pool.add(att)
        await a.net.publish_attestation(att, subnet=subnet)
        await poll(lambda: _votes(b, 2) == 1, "the attestation in the receiver's pool")
        pooled = [bytes(s) for g in b.chain.att_pool._by_slot[2].values()
                  for _bits, s in g.bits_and_sigs]
        assert pooled == [bytes(att.signature)]
        await b.close()
        await a.close()

    asyncio.run(main())
