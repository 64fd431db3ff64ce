"""Checkpoint sync and backfill on the port against the JAX package's
(``tests/test_checkpoint_backfill.py``'s cases): node B fetches node A's
finalized state over REST, anchors its chain on it, backfills history to
genesis over req/resp with the proposer signatures verified through its
pool, and range-syncs forward to A's head; the weak-subjectivity guard
refuses a stale checkpoint; swapped signatures are stored nowhere and
penalize the peer.  Run with a port A and a port B, and with a JAX A and a
port B (the state crosses as SSZ over REST, the blocks over the wire);
each outcome equals the JAX-to-JAX run's.  16 interop validators, phase0."""

import asyncio
import importlib

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
WAIT_S = 60.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def cfg(pkg):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N,
        ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)


def pool(pkg):
    return mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)


def network(pkg, chain):
    return mod(pkg, "network").Network(mod(pkg, "params").MINIMAL, chain,
                                       mod(pkg, "chain.handlers").GossipHandlers(chain))


def checkpoint_then_backfill(server: str, client: str) -> dict:
    p_a, p_b = mod(server, "params").MINIMAL, mod(client, "params").MINIMAL
    cs = mod(client, "node.checkpoint_sync")

    async def main():
        pool_a = pool(server)
        a = mod(server, "node.dev_chain").DevChain(p_a, cfg(server), N, pool_a)
        await a.run(4 * p_a.SLOTS_PER_EPOCH + 2)
        fin = a.chain.fork_choice.store.finalized_checkpoint
        assert fin.epoch >= 1
        net_a = network(server, a.chain)
        port_a = await net_a.listen(0)
        rest_a = mod(server, "api").RestApiServer(p_a, a.chain, network=net_a)
        url = f"http://127.0.0.1:{await rest_a.listen(0)}"
        with pytest.raises(cs.CheckpointSyncError, match="weak-subjectivity"):
            await cs.fetch_checkpoint_state(p_b, cfg(client), url, current_epoch=10**6)
        now_epoch = a.clock.current_slot // p_a.SLOTS_PER_EPOCH
        state, anchor_block, anchor_root = await asyncio.wait_for(
            cs.fetch_checkpoint_state(p_b, cfg(client), url, current_epoch=now_epoch), WAIT_S)
        assert anchor_root == fin.root and state.slot > 0
        pool_b = pool(client)
        chain_b = mod(client, "chain.beacon_chain").BeaconChain(p_b, cfg(client), state, pool_b)
        chain_b.db.block.put(anchor_root, anchor_block)
        chain_b.db.archive_block(anchor_block, anchor_root)
        assert chain_b.head_root == anchor_root
        net_b = network(client, chain_b)
        await asyncio.wait_for(net_b.connect("127.0.0.1", port_a), WAIT_S)
        backfill = mod(client, "sync.backfill").BackfillSync(
            p_b, cfg(client), chain_b.db, pool_b, state, anchor_root, net_b.peer_manager)
        stored = await asyncio.wait_for(backfill.run(), WAIT_S)
        historical = [bytes(mod(client, "types").get_types(p_b).phase0.SignedBeaconBlock
                            .hash_tree_root(b))
                      for b in chain_b.db.archived_blocks_by_slot_range(1, state.slot + 1)]
        marker = chain_b.db.backfilled_ranges.get(b"backfill")
        sync = mod(client, "sync").RangeSync(p_b, chain_b, net_b.peer_manager)
        imported = await asyncio.wait_for(sync.run_to_head(), WAIT_S)
        assert sync.state == mod(client, "sync").SyncState.synced
        assert chain_b.head_root == a.chain.head_root
        await net_b.close()
        await net_a.close()
        await rest_a.close()
        pool_a.close()
        pool_b.close()
        return dict(anchor=anchor_root, anchor_slot=int(state.slot), stored=stored,
                    oldest=backfill.oldest_slot, historical=historical,
                    marker=dict(marker) if marker is not None else None,
                    imported=imported, head=chain_b.head_root)

    return asyncio.run(main())


@pytest.fixture(scope="module")
def reference():
    out = checkpoint_then_backfill("jax", "jax")
    assert out["oldest"] is not None and out["oldest"] <= 1 and out["stored"] > 0
    assert len(out["historical"]) >= out["stored"]
    assert out["marker"] is not None and out["marker"]["oldest_slot"] <= 1
    return out


@pytest.mark.parametrize("server", ["port", "jax"])
def test_checkpoint_sync_then_backfill_then_follow_equal_the_jax_nodes(reference, server):
    assert checkpoint_then_backfill(server, "port") == reference


def tampered_history(pkg: str) -> dict:
    p = mod(pkg, "params").MINIMAL

    async def main():
        pool_a = pool(pkg)
        a = mod(pkg, "node.dev_chain").DevChain(p, cfg(pkg), N, pool_a)
        await a.run(2 * p.SLOTS_PER_EPOCH, with_attestations=False)
        net_a = network(pkg, a.chain)
        port_a = await net_a.listen(0)
        head_root = a.chain.head_root
        head_block = a.chain.get_block_by_root(head_root)
        state = a.chain.head_state()
        pool_b = pool(pkg)
        chain_b = mod(pkg, "chain.beacon_chain").BeaconChain(p, cfg(pkg), state, pool_b)
        chain_b.db.block.put(head_root, head_block)
        chain_b.db.archive_block(head_block, head_root)
        net_b = network(pkg, chain_b)
        peer = await asyncio.wait_for(net_b.connect("127.0.0.1", port_a), WAIT_S)
        orig = peer.reqresp.blocks_by_range

        async def tampered(start, count, step=1):
            blocks = await orig(start, count, step)
            if len(blocks) >= 2:
                s0 = bytes(blocks[0].signature)
                blocks[0].signature = bytes(blocks[1].signature)
                blocks[1].signature = s0
            return blocks

        peer.reqresp.blocks_by_range = tampered
        backfill = mod(pkg, "sync.backfill").BackfillSync(
            p, cfg(pkg), chain_b.db, pool_b, state, head_root, net_b.peer_manager)
        stored = await asyncio.wait_for(backfill.run(max_batches=3), WAIT_S)
        assert stored == 0 and peer.score < 0
        await net_b.close()
        await net_a.close()
        pool_a.close()
        pool_b.close()
        return dict(stored=stored, score=peer.score, oldest=backfill.oldest_slot)

    return asyncio.run(main())


def test_backfill_refuses_tampered_history_as_the_jax_node_does():
    assert tampered_history("port") == tampered_history("jax")
