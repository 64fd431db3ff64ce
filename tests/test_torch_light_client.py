"""The port's light-client server against the JAX package's
(``tests/test_light_client.py``'s server side): over the same Altair dev
chain (16 interop validators, Altair at epoch 1, 42 slots) the port's
bootstrap, best update per period, latest update, finality and optimistic
updates equal the JAX server's as JSON, and the best update's SSZ bytes
equal too; the JAX package's light client bootstraps from the port's
bootstrap, follows the port's updates (over the port's REST API as well)
to a finalized header past genesis, and refuses the same tampered
updates.  The port's light client is held against the JAX one in
``tests/test_torch_light_client_client.py``."""

import asyncio
import importlib

import pytest

from lodestar_tpu.api.serde import from_json as j_from_json
from lodestar_tpu.light_client import LightClient, LightClientError

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
N_SLOTS = 5 * 8 + 2


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def cfg(pkg):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=1,
        BELLATRIX_FORK_EPOCH=2**64 - 1)


@pytest.fixture(scope="module")
def servers():
    loop = asyncio.new_event_loop()
    out = {}
    for pkg in PKGS:
        p = mod(pkg, "params").MINIMAL
        pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
            mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)
        dev = mod(pkg, "node.dev_chain").DevChain(p, cfg(pkg), N, pool)
        server = mod(pkg, "chain.light_client").LightClientServer(p, dev.chain)
        loop.run_until_complete(dev.run(N_SLOTS))
        out[pkg] = dict(dev=dev, server=server, pool=pool, p=p)
    assert out["port"]["dev"].chain.head_root == out["jax"]["dev"].chain.head_root
    out["loop"] = loop
    yield out
    for pkg in PKGS:
        out[pkg]["pool"].close()
    loop.close()


def _boot_root(node):
    chain = node["dev"].chain
    return chain.fork_choice.get_ancestor(chain.head_root, node["p"].SLOTS_PER_EPOCH + 1)


def test_server_outputs_equal_the_jax_servers(servers):
    got, want = {}, {}
    for pkg, out in (("port", got), ("jax", want)):
        node, to_json = servers[pkg], mod(pkg, "api.serde").to_json
        s = node["server"]
        out["bootstrap"] = to_json(s.get_bootstrap(_boot_root(node)))
        out["periods"] = sorted(s.best_update_by_period)
        out["updates"] = [to_json(s.get_update(k)) for k in out["periods"]]
        out["latest"] = to_json(s.get_latest_update())
        out["finality"] = to_json(s.get_finality_update())
        out["optimistic"] = to_json(s.get_optimistic_update())
        t = mod(pkg, "types").get_types(node["p"]).altair.LightClientUpdate
        out["ssz"] = t.serialize(s.get_latest_update())
    assert got["updates"] and got == want


def test_jax_light_client_follows_the_port_servers_updates(servers):
    node = servers["port"]
    to_json = mod("port", "api.serde").to_json
    s = node["server"]
    cross = lambda obj: j_from_json(to_json(obj))  # noqa: E731 - JSON across the packages
    bootstrap = cross(s.get_bootstrap(_boot_root(node)))
    gvr = bytes(node["dev"].chain.genesis_state.genesis_validators_root)
    jcfg = mod("jax", "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=1,
        BELLATRIX_FORK_EPOCH=2**64 - 1)
    jp = mod("jax", "params").MINIMAL
    lc = LightClient(jp, jcfg, bootstrap, gvr)
    update = cross(s.get_latest_update())
    assert sum(update.sync_aggregate.sync_committee_bits) == jp.SYNC_COMMITTEE_SIZE
    lc.process_update(update)
    assert lc.optimistic_header.slot > bootstrap.header.slot
    assert lc.finalized_header.slot > 0
    bad = cross(s.get_latest_update())
    bad.sync_aggregate.sync_committee_bits = [False] * jp.SYNC_COMMITTEE_SIZE
    with pytest.raises(LightClientError):
        lc.process_update(bad)
    bad = cross(s.get_latest_update())
    bad.attested_header.state_root = b"\x13" * 32
    with pytest.raises(LightClientError):
        lc.process_update(bad)


def test_jax_light_client_over_the_port_rest_api(servers):
    from lodestar_tpu.api import ApiClient
    from lodestar_tpu_torch.api import RestApiServer

    node, loop = servers["port"], servers["loop"]

    async def main():
        rest = RestApiServer(node["p"], node["dev"].chain)
        rest.light_client_server = node["server"]
        api = ApiClient("127.0.0.1", await rest.listen(0))
        boot = await api.get(f"/eth/v1/beacon/light_client/bootstrap/0x{_boot_root(node).hex()}")
        jp = mod("jax", "params").MINIMAL
        jcfg = mod("jax", "config.chain_config").ChainConfig(
            PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
            MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=1,
            BELLATRIX_FORK_EPOCH=2**64 - 1)
        gvr = bytes(node["dev"].chain.genesis_state.genesis_validators_root)
        lc = LightClient(jp, jcfg, j_from_json(boot["data"]), gvr)
        ups = await api.get("/eth/v1/beacon/light_client/updates?start_period=0&count=4")
        assert ups["data"]
        for u in ups["data"]:
            lc.process_update(j_from_json(u))
        assert lc.finalized_header.slot > 0
        fu = await api.get("/eth/v1/beacon/light_client/finality_update")
        lc.process_finality_update(j_from_json(fu["data"]))
        assert lc.finalized_header.slot >= j_from_json(fu["data"]).finalized_header.slot
        ou = await api.get("/eth/v1/beacon/light_client/optimistic_update")
        lc.process_optimistic_update(j_from_json(ou["data"]))
        assert lc.optimistic_header.slot >= j_from_json(ou["data"]).attested_header.slot
        await rest.close()

    loop.run_until_complete(main())


def test_update_ssz_roundtrip_keeps_signature_slot_as_the_jax_type():
    out = {}
    for pkg in PKGS:
        p, Fields = mod(pkg, "params").MINIMAL, mod(pkg, "ssz").Fields
        typ = mod(pkg, "types").get_types(p).altair.LightClientUpdate
        names = [name for name, _ in typ.fields]
        assert "signature_slot" in names and "fork_version" not in names
        header = Fields(slot=97, proposer_index=3, parent_root=b"\x11" * 32,
                        state_root=b"\x22" * 32, body_root=b"\x33" * 32)
        update = Fields(
            attested_header=header,
            next_sync_committee=Fields(pubkeys=[bytes([i]) * 48
                                                for i in range(p.SYNC_COMMITTEE_SIZE)],
                                       aggregate_pubkey=b"\xaa" * 48),
            next_sync_committee_branch=[bytes([i]) * 32 for i in range(5)],
            finalized_header=Fields(slot=64, proposer_index=1, parent_root=b"\x44" * 32,
                                    state_root=b"\x55" * 32, body_root=b"\x66" * 32),
            finality_branch=[bytes([10 + i]) * 32 for i in range(6)],
            sync_aggregate=Fields(
                sync_committee_bits=[i % 2 == 0 for i in range(p.SYNC_COMMITTEE_SIZE)],
                sync_committee_signature=b"\x77" * 96),
            signature_slot=103)
        blob = typ.serialize(update)
        back = typ.deserialize(blob)
        assert int(back.signature_slot) == 103 and back.attested_header.slot == 97
        out[pkg] = (names, blob)
    assert out["port"] == out["jax"]
