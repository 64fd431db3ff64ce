"""UDP discovery on the port against the JAX package's
(``tests/test_discovery.py``'s cases): a signed node record encodes to the
JAX record's bytes and each package verifies the other's records and
refuses the same forgeries; three services, one of them the JAX package's,
find each other transitively and carry a subnet update; a port network
dials the peer its discovery found."""

import asyncio
import importlib

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
WAIT_S = 30.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def records(pkg: str) -> dict:
    d, api = mod(pkg, "network.discovery"), mod(pkg, "crypto.bls.api")
    sk, other = api.interop_secret_key(1), api.interop_secret_key(2)
    rec = d.NodeRecord(seq=1, pubkey=sk.to_public_key().to_bytes(), ip="127.0.0.1",
                       tcp_port=9000, udp_port=9001).sign(sk)
    stolen = d.NodeRecord(seq=9, pubkey=other.to_public_key().to_bytes(), ip="10.0.0.1",
                          tcp_port=1, udp_port=1).sign(sk)
    return dict(rec=rec.encode(), node_id=rec.node_id, stolen=stolen.encode())


def test_records_and_forgeries_equal_the_jax_packages():
    port, jax = records("port"), records("jax")
    assert port == jax
    for pkg in PKGS:
        NodeRecord = mod(pkg, "network.discovery").NodeRecord
        decoded = NodeRecord.decode(jax["rec"])
        assert decoded.verify_signature() and decoded.node_id == jax["node_id"]
        forged = NodeRecord.decode(port["rec"])
        forged.tcp_port = 6666
        assert not forged.verify_signature()
        assert not NodeRecord.decode(port["stolen"]).verify_signature()


def test_three_node_transitive_discovery_across_the_packages():
    """A (port) and C (port) know only B (JAX); A learns C through B, and
    C's subnet update reaches A's table."""

    async def main():
        found = {"a": [], "b": [], "c": []}
        svcs = {}
        for name, idx, pkg in (("a", 1, "port"), ("b", 2, "jax"), ("c", 3, "port")):
            svc = mod(pkg, "network.discovery").DiscoveryService(
                mod(pkg, "crypto.bls.api").interop_secret_key(idx), tcp_port=9000 + idx,
                on_peer=lambda rec, _n=name: found[_n].append(rec))
            await svc.listen(0)
            svcs[name] = svc
        svcs["a"].add_bootstrap("127.0.0.1", svcs["b"].udp_port)
        svcs["c"].add_bootstrap("127.0.0.1", svcs["b"].udp_port)
        await asyncio.sleep(0.3)
        svcs["a"].find_nodes()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + WAIT_S
        while len(svcs["a"].table) < 2 and loop.time() < deadline:
            await asyncio.sleep(0.05)
        ids_a = {e.record.pubkey for e in svcs["a"].table.values()}
        assert svcs["c"].record.pubkey in ids_a and svcs["b"].record.pubkey in ids_a
        assert any(r.pubkey == svcs["c"].record.pubkey for r in found["a"])
        svcs["c"].update_subnets([False] * 63 + [True], [True, False, False, False])
        deadline = loop.time() + WAIT_S
        while loop.time() < deadline:
            svcs["a"].find_nodes()
            await asyncio.sleep(0.2)
            entry = svcs["a"].table.get(svcs["c"].record.node_id)
            if entry is not None and entry.record.attnets[7] & 0x80:
                break
        entry = svcs["a"].table.get(svcs["c"].record.node_id)
        assert entry is not None and entry.record.attnets[7] & 0x80
        for svc in svcs.values():
            await svc.close()

    asyncio.run(main())


def test_port_network_dials_discovered_peers():
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.chain.handlers import GossipHandlers
    from lodestar_tpu_torch.config.chain_config import ChainConfig
    from lodestar_tpu_torch.crypto.bls.api import interop_secret_key
    from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
    from lodestar_tpu_torch.network import Network
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.params import MINIMAL

    async def main():
        cfg = ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                          MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16,
                          ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)
        pools, nets = [], []
        for _ in range(2):
            pool = BlsBatchPool(FastBlsVerifier(), max_buffer_wait=0.005)
            dev = DevChain(MINIMAL, cfg, 16, pool)
            net = Network(MINIMAL, dev.chain, GossipHandlers(dev.chain))
            await net.listen(0)
            pools.append(pool)
            nets.append(net)
        udp_a = await nets[0].enable_discovery(interop_secret_key(11))
        await nets[1].enable_discovery(interop_secret_key(12), bootstrap=[("127.0.0.1", udp_a)])
        loop = asyncio.get_running_loop()
        deadline = loop.time() + WAIT_S
        while not (nets[1].peer_manager.peers and nets[0].peer_manager.peers):
            assert loop.time() < deadline, "the discovered peer was never dialed"
            await asyncio.sleep(0.05)
        for net in nets:
            await net.close()
        for pool in pools:
            pool.close()

    asyncio.run(main())
