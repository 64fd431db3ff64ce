"""The port's two-node loopback and wired-node cases against the JAX
package's: ``tests/test_network_sync.py``'s handshake and range sync,
gossip block propagation with unknown-parent resolution, and range sync
past a peer serving garbage, and ``tests/test_node_wiring.py``'s wired
node (regen-backed imports, the database, op-pool packing, the archiver,
a restart from disk).  Each scenario runs in each package over its own
``FastBlsVerifier`` pool, 16 or 32 interop validators, phase0; every
outcome (heads, imported counts, the downscored peer, archived slots,
rebuilt state roots) is the JAX package's, exactly.  Every network wait
is bounded."""

import asyncio
import importlib

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
WAIT_S = 60.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def cfg(pkg: str, n: int):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=n,
        ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)


def pool(pkg: str):
    return mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)


def dev_chain(pkg: str, n: int = 16, bls=None, db=None):
    bls = bls or pool(pkg)
    return mod(pkg, "node.dev_chain").DevChain(mod(pkg, "params").MINIMAL, cfg(pkg, n), n, bls,
                                               db=db), bls


def network(pkg: str, dev):
    handlers = mod(pkg, "chain.handlers").GossipHandlers(dev.chain)
    return mod(pkg, "network").Network(mod(pkg, "params").MINIMAL, dev.chain, handlers)


async def poll(pred, what: str):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + WAIT_S
    while not pred():
        assert loop.time() < deadline, f"{what} not reached in {WAIT_S} s"
        await asyncio.sleep(0.02)


def handshake_and_range_sync(pkg: str) -> dict:
    sync_mod = mod(pkg, "sync")
    spe = mod(pkg, "params").MINIMAL.SLOTS_PER_EPOCH

    async def main():
        a, pool_a = dev_chain(pkg)
        b, pool_b = dev_chain(pkg)
        await a.run(2 * spe + 4, with_attestations=False)
        net_a, net_b = network(pkg, a), network(pkg, b)
        port = await net_a.listen(0)
        peer = await asyncio.wait_for(net_b.connect("127.0.0.1", port), WAIT_S)
        assert peer.status is not None
        assert peer.status.head_slot == a.chain.head_state().slot
        assert await asyncio.wait_for(peer.reqresp.ping(7), WAIT_S) == 7
        md = await asyncio.wait_for(peer.reqresp.metadata(), WAIT_S)
        sync = sync_mod.RangeSync(mod(pkg, "params").MINIMAL, b.chain, net_b.peer_manager)
        imported = await asyncio.wait_for(sync.run_to_head(), WAIT_S)
        assert sync.state == sync_mod.SyncState.synced
        assert b.chain.head_root == a.chain.head_root
        await net_b.close()
        await net_a.close()
        pool_a.close()
        pool_b.close()
        return dict(imported=imported, head=b.chain.head_root, seq=int(md.seq_number),
                    status=(int(peer.status.head_slot), bytes(peer.status.head_root),
                            bytes(peer.status.fork_digest)))

    return asyncio.run(main())


def test_handshake_and_range_sync_equal_the_jax_nodes():
    port = handshake_and_range_sync("port")
    assert port["imported"] == 20
    assert port == handshake_and_range_sync("jax")


def gossip_block_and_unknown_parent(pkg: str) -> dict:
    sync_mod = mod(pkg, "sync")

    async def main():
        a, pool_a = dev_chain(pkg)
        b, pool_b = dev_chain(pkg)
        net_a, net_b = network(pkg, a), network(pkg, b)
        port = await net_a.listen(0)
        await asyncio.wait_for(net_b.connect("127.0.0.1", port), WAIT_S)
        signed = await a.produce_and_import_block(1)
        b.clock.set_slot(1)
        n_sent = await net_a.publish_block(signed)
        assert n_sent == 1
        await poll(lambda: b.chain.head_root == a.chain.head_root, "the gossiped block")
        head1 = b.chain.head_root
        await a.produce_and_import_block(2)
        s3 = await a.produce_and_import_block(3)
        b.clock.set_slot(3)
        ub = sync_mod.UnknownBlockSync(mod(pkg, "params").MINIMAL, b.chain, net_b.peer_manager)
        peer_b = net_b.peer_manager.connected()[0]
        await net_b.peer_manager.handshake(peer_b, peer_b.reqresp.local_status())
        ok = await asyncio.wait_for(ub.resolve(s3), WAIT_S)
        assert ok
        assert b.chain.head_root == a.chain.head_root
        await net_b.close()
        await net_a.close()
        pool_a.close()
        pool_b.close()
        return dict(n_sent=n_sent, head1=head1, head3=b.chain.head_root)

    return asyncio.run(main())


def test_gossip_block_propagation_and_unknown_parent_equal_the_jax_nodes():
    assert gossip_block_and_unknown_parent("port") == gossip_block_and_unknown_parent("jax")


def range_sync_past_a_garbage_peer(pkg: str) -> dict:
    Fields = mod(pkg, "ssz").Fields
    minimal = mod(pkg, "params").MINIMAL

    async def main():
        a, pool_a = dev_chain(pkg)
        b, pool_b = dev_chain(pkg)
        c, pool_c = dev_chain(pkg)
        await a.run(minimal.SLOTS_PER_EPOCH + 4, with_attestations=False)
        for slot in range(1, minimal.SLOTS_PER_EPOCH + 5):
            root = a.chain.fork_choice.proto.get_ancestor(a.chain.head_root, slot)
            blk = a.chain.get_block_by_root(root) if root else None
            if blk is not None and blk.message.slot == slot:
                b.clock.set_slot(slot)
                await b.chain.process_block(blk)
        assert b.chain.head_root == a.chain.head_root
        net_a, net_b, net_c = network(pkg, a), network(pkg, b), network(pkg, c)
        port_a = await net_a.listen(0)
        port_b = await net_b.listen(0)
        await asyncio.wait_for(net_c.connect("127.0.0.1", port_a), WAIT_S)
        peer_bad = await asyncio.wait_for(net_c.connect("127.0.0.1", port_b), WAIT_S)
        orig = peer_bad.reqresp.blocks_by_range

        async def garbage(start, count, step=1):
            blocks = await orig(start, count, step)
            for blk in blocks:
                blk.message.state_root = b"\xde\xad" * 16
            return blocks

        peer_bad.reqresp.blocks_by_range = garbage
        peer_bad.status = Fields(
            fork_digest=peer_bad.status.fork_digest, finalized_root=peer_bad.status.finalized_root,
            finalized_epoch=peer_bad.status.finalized_epoch,
            head_root=peer_bad.status.head_root, head_slot=peer_bad.status.head_slot + 1)
        reports = []

        async def report(peer, action, reason):
            reports.append((peer.peer_id, str(getattr(action, "name", action))))

        sync = mod(pkg, "sync").RangeSync(minimal, c.chain, net_c.peer_manager,
                                          report_peer=report)
        imported = await asyncio.wait_for(sync.run_to_head(), WAIT_S)
        assert imported > 0 and c.chain.head_root == a.chain.head_root
        assert any(pid == peer_bad.peer_id for pid, _ in reports)
        await net_c.close()
        await net_b.close()
        await net_a.close()
        for p in (pool_a, pool_b, pool_c):
            p.close()
        bad = peer_bad.peer_id
        return dict(imported=imported, head=c.chain.head_root,
                    reports=[("bad" if pid == bad else "honest", action) for pid, action in reports])

    return asyncio.run(main())


def test_range_sync_past_a_garbage_peer_equals_the_jax_nodes():
    assert range_sync_past_a_garbage_peer("port") == range_sync_past_a_garbage_peer("jax")


def wired_node(pkg: str) -> dict:
    """test_node_wiring's wired node, reduced to its outcomes."""
    m = lambda name: mod(pkg, name)  # noqa: E731
    minimal = m("params").MINIMAL
    Fields = m("ssz").Fields
    st = m("state_transition")
    T = m("types").get_types(minimal).phase0
    n = 32

    def make_exit(dev, validator_index):
        state = dev.chain.head_state()
        epoch = st.compute_epoch_at_slot(dev.p, state.slot)
        msg = Fields(epoch=0, validator_index=validator_index)
        domain = st.get_domain(dev.p, state, m("params").DOMAIN_VOLUNTARY_EXIT, epoch)
        root = st.compute_signing_root(dev.p, T.VoluntaryExit, msg, domain)
        return Fields(message=msg, signature=dev.keys[validator_index].sign(root).to_bytes())

    def proposer_of(dev, slot):
        state = st.clone_state(dev.p, dev.chain.head_state())
        return st.process_slots(dev.p, cfg(pkg, n), state, slot).get_beacon_proposer(slot)

    async def main():
        db = m("db.beacon").BeaconDb(minimal, m("db.controller").MemoryDbController())
        dev, bls = dev_chain(pkg, n, db=db)
        chain = dev.chain
        handlers = m("chain.handlers").GossipHandlers(chain)
        await dev.run(4 * minimal.SLOTS_PER_EPOCH + 2)
        assert chain.head_state().finalized_checkpoint.epoch >= 1
        archived = [int(b.message.slot) for b in
                    db.archived_blocks_by_slot_range(0, minimal.SLOTS_PER_EPOCH + 1)]
        assert archived and db.last_archived_slot() is not None
        await handlers.on_voluntary_exit(make_exit(dev, 5))
        assert 5 in chain.op_pool.voluntary_exits
        slot = chain.head_state().slot + 1
        state = chain.head_state()
        proposer = proposer_of(dev, slot)
        randao = dev._sign_randao(state, proposer=proposer,
                                  epoch=st.compute_epoch_at_slot(dev.p, slot))
        block, proposer = chain.produce_block(slot, randao)
        assert len(block.body.voluntary_exits) == 1
        n_atts = None
        att = dev.pending_attestations[-1] if dev.pending_attestations else None
        if att is not None:
            chain.agg_pool.add(att)
            block2, _ = chain.produce_block(slot, randao)
            n_atts = len(block2.body.attestations)
            assert n_atts >= 1
        signed = Fields(message=block, signature=dev._sign_block(state, block, proposer))
        root = await chain.process_block(signed)
        assert chain.fork_choice.has_block(root)
        assert len(chain.state_cache) <= chain.state_cache.max_states
        head_root = chain.head_root
        head_state_root = T.BeaconState.hash_tree_root(chain.head_state())
        chain.state_cache._map.clear()
        anchor = chain.fork_choice.proto.nodes[0].block_root
        chain.state_cache.add(anchor, chain.genesis_state)
        rebuilt = chain.regen.get_state_by_block_root(head_root, max_replay=64)
        assert T.BeaconState.hash_tree_root(rebuilt) == head_state_root
        db2 = m("db.beacon").BeaconDb(minimal, db.db)
        assert db2.last_archived_state() is not None
        dev2, _ = dev_chain(pkg, n, bls=bls, db=db2)
        count = 0
        for blk in db2.archived_blocks_by_slot_range(1, 10_000):
            await dev2.chain.process_block(blk)
            count += 1
        hot = sorted((db2.block.get(k) for k in db2.block.keys()), key=lambda b: b.message.slot)
        for blk in hot:
            if blk.message.slot > dev2.chain.head_state().slot:
                await dev2.chain.process_block(blk)
                count += 1
        assert count > 0 and dev2.chain.head_root == chain.head_root
        bls.close()
        return dict(archived=archived, last_archived=db.last_archived_slot(), block=root,
                    n_atts=n_atts, head=head_root, state_root=head_state_root, replayed=count)

    return asyncio.run(main())


def test_wired_node_equals_the_jax_wired_node():
    assert wired_node("port") == wired_node("jax")
