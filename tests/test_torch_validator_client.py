"""The port's validator client (``validator/client.py``) against the JAX
package's, over the nodes' REST APIs on the loopback, each node a
``DevChain``'s chain over ``FastBlsVerifier`` (16 interop validators,
minimal preset) with no producer of its own and a manual clock set to
each slot:

- one phase0 epoch of duties (proposals, attestations, aggregates) by the
  port's client against a port node, the JAX client against a JAX node,
  the port's client against a JAX node and the JAX client against a port
  node: every slot's head root and block bytes are the same in the four
  runs, and every vote of slots 1-7 is in a block;
- sync-committee duties after Altair: the same messages submitted, the
  same contribution pooled, the same sync aggregate in the next block;
- doppelganger protection over the liveness route refuses and clears as
  the JAX client does.

Exact bytes and roots.  About 30 s on one core."""

import asyncio
import importlib

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
EPOCH = 8


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _config(pkg: str, altair=2**64 - 1):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=altair,
        BELLATRIX_FORK_EPOCH=2**64 - 1)


async def _node(pkg: str, altair=2**64 - 1):
    """A node: a dev chain (its producer unused), REST with the gossip
    handlers, its pool over the host C verifier."""
    pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)
    p = mod(pkg, "params").MINIMAL
    dev = mod(pkg, "node.dev_chain").DevChain(p, _config(pkg, altair), N, pool)
    rest = mod(pkg, "api").RestApiServer(p, dev.chain)
    rest.gossip_handlers = mod(pkg, "chain.handlers").GossipHandlers(dev.chain)
    port = await rest.listen(0)
    return dict(pool=pool, dev=dev, rest=rest, port=port, p=p)


def _client(pkg: str, node: dict, indices=range(N), altair=2**64 - 1, **kw):
    p = mod(pkg, "params").MINIMAL
    bls, validator = mod(pkg, "crypto.bls.api"), mod(pkg, "validator")
    api = mod(pkg, "api.client").ApiClient("127.0.0.1", node["port"])
    gvr = bytes(node["dev"].chain.genesis_state.genesis_validators_root)
    store = validator.ValidatorStore(p, _config(pkg, altair),
                                     {i: bls.interop_secret_key(i) for i in indices},
                                     genesis_validators_root=gvr)
    return validator.ValidatorClient(p, _config(pkg, altair), store, api, **kw)


async def _close(node):
    await node["rest"].close()
    node["pool"].close()


def _drive(node_pkg: str, vc_pkg: str) -> dict:
    async def run():
        node = await _node(node_pkg)
        vc = _client(vc_pkg, node)
        chain = node["dev"].chain
        t = mod(node_pkg, "types").get_types(node["p"]).phase0
        heads, blocks = [], []
        for slot in range(1, EPOCH + 1):
            node["dev"].clock.set_slot(slot)
            await vc.run_slot(slot)
            heads.append(chain.head_root.hex())
            blocks.append(t.SignedBeaconBlock.serialize(chain.get_block_by_root(chain.head_root)))
        seen = set()
        for raw in blocks:
            for att in t.SignedBeaconBlock.deserialize(raw).message.body.attestations:
                seen |= {(int(att.data.slot), int(att.data.index), i)
                         for i, bit in enumerate(att.aggregation_bits) if bit}
        duties = [(int(d["slot"]), int(d["committee_index"]), int(d["validator_committee_index"]))
                  for d in vc._attester_duties[0] if 1 <= int(d["slot"]) < EPOCH]
        state = chain.head_state()
        await _close(node)
        return dict(heads=heads, blocks=blocks, slot=int(state.slot),
                    missing=[d for d in duties if d not in seen], votes=len(duties))

    return asyncio.run(run())


@pytest.fixture(scope="module")
def runs():
    return {(node, vc): _drive(node, vc) for node in PKGS for vc in PKGS}


def test_port_client_and_node_in_lockstep_with_the_jax_pair(runs):
    got, want = runs[("port", "port")], runs[("jax", "jax")]
    assert got["slot"] == EPOCH and len(set(got["heads"])) == EPOCH
    assert got["votes"] == N - N // EPOCH and got["missing"] == []  # slot 0 never attests
    assert got == want


@pytest.mark.parametrize("node,vc", [("jax", "port"), ("port", "jax")])
def test_a_client_of_one_package_drives_a_node_of_the_other(runs, node, vc):
    assert runs[(node, vc)] == runs[("jax", "jax")]


def test_sync_committee_duties_after_altair_equal_the_jax_clients():
    async def run(pkg):
        node = await _node(pkg, altair=1)
        dev, chain = node["dev"], node["dev"].chain
        await dev.run(EPOCH + 2, with_attestations=False)  # across the Altair fork
        vc = _client(pkg, node, altair=1)
        slot = int(chain.head_state().slot)
        dev.clock.set_slot(slot)
        submitted = await vc.sync_committee_duties(slot)
        agg = chain.contribution_pool.get_sync_aggregate(slot, chain.head_root)
        st = mod(pkg, "state_transition")
        nxt = slot + 1
        state = st.clone_state(dev.p, chain.head_state())
        ctx = st.process_slots(dev.p, chain.cfg, state, nxt)
        proposer = ctx.get_beacon_proposer(nxt)
        randao = dev._sign_randao(state, proposer, st.compute_epoch_at_slot(dev.p, nxt))
        block, _ = chain.produce_block(nxt, randao)
        await _close(node)
        return dict(submitted=submitted, bits=list(agg.sync_committee_bits),
                    signature=bytes(agg.sync_committee_signature),
                    block_bits=list(block.body.sync_aggregate.sync_committee_bits),
                    block_signature=bytes(block.body.sync_aggregate.sync_committee_signature))

    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert got["submitted"] > 0 and any(got["block_bits"])
    assert got == want


def test_doppelganger_over_liveness_equals_the_jax_client():
    async def run(pkg):
        node = await _node(pkg)
        await node["dev"].run(EPOCH + 2)  # an epoch of attestations: 0-3 live
        out = []
        vc = _client(pkg, node, indices=range(4), doppelganger_epochs=2)
        try:
            await vc.check_doppelganger(2)
            out.append("clean")
        except vc.DoppelgangerDetected as e:
            out.append(str(e))
        # keys outside the chain's validators: the window clears once its
        # epochs have passed clean
        far = _client(pkg, node, indices=range(10_000, 10_002), doppelganger_epochs=1)
        out += [await far.check_doppelganger(2), await far.check_doppelganger(3)]
        await _close(node)
        return out

    got = asyncio.run(run("port"))
    assert got[0].startswith("validators ") and got[1:] == [False, True]
    assert got == asyncio.run(run("jax"))
