"""The port's light client (``light_client/client.py``) against the JAX
package's, fed the same updates.  One Altair dev chain (16 interop
validators, Altair at epoch 1, minimal preset) is built once, by the port,
into sync-committee period 2 with its light-client server; its bootstrap
and updates cross to each package as JSON, and both clients must reach the
same headers after every step:

- following finality: the period ladder, the finality and optimistic
  updates, and the same refusals of tampered updates;
- the two-period gap: the ladder through periods 0, 1 and 2, and a client
  whose update has its finality stripped, advanced by ``force_update``
  past the timeout;
- the update's SSZ round trip keeps ``signature_slot``, with the JAX
  type's bytes.

Exact headers and bytes.  About 55 s on one core, 50 s of it the chain's 146 slots."""

import asyncio
import importlib

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
EPOCH = 8
PERIOD = 8 * EPOCH  # minimal: 8 epochs a sync-committee period


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _config(pkg: str):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=1,
        BELLATRIX_FORK_EPOCH=2**64 - 1)


@pytest.fixture(scope="module")
def chain():
    """The port's chain into period 2: the bootstrap at the first slot of
    epoch 1 plus one (taken while its state is in the cache), every
    period's best update, the latest finality and optimistic updates, all
    as JSON."""
    to_json = mod("port", "api.serde").to_json
    p = mod("port", "params").MINIMAL

    async def run():
        pool = mod("port", "chain.bls_pool").BlsBatchPool(
            mod("port", "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)
        dev = mod("port", "node.dev_chain").DevChain(p, _config("port"), N, pool)
        server = mod("port", "chain.light_client").LightClientServer(p, dev.chain)
        await dev.run(2 * EPOCH + 2)
        boot_root = dev.chain.fork_choice.get_ancestor(dev.chain.head_root, EPOCH + 1)
        bootstrap = to_json(server.get_bootstrap(boot_root))
        await dev.run(2 * PERIOD)
        out = dict(bootstrap=bootstrap, gvr=bytes(dev.chain.genesis_state.genesis_validators_root),
                   updates={k: to_json(server.get_update(k))
                            for k in sorted(server.best_update_by_period)},
                   finality=to_json(server.get_finality_update()),
                   optimistic=to_json(server.get_optimistic_update()))
        pool.close()
        return out

    out = asyncio.run(run())
    assert sorted(out["updates"]) == [0, 1, 2]
    return out


def _client(pkg: str, chain: dict):
    from_json = mod(pkg, "api.serde").from_json
    lc = mod(pkg, "light_client").LightClient(mod(pkg, "params").MINIMAL, _config(pkg),
                                               from_json(chain["bootstrap"]), chain["gvr"])
    return lc, from_json


def _headers(lc) -> dict:
    return {name: (int(h.slot), int(h.proposer_index), bytes(h.parent_root).hex(),
                   bytes(h.state_root).hex(), bytes(h.body_root).hex())
            for name, h in (("optimistic", lc.optimistic_header),
                            ("finalized", lc.finalized_header))}


def _step(pkg: str, lc, call, *args) -> str:
    """One call on a client: "ok", or the refusal's message."""
    try:
        call(*args)
        return "ok"
    except mod(pkg, "light_client").LightClientError as e:
        return f"refused: {e}"


def _follow(pkg: str, chain: dict) -> list:
    lc, from_json = _client(pkg, chain)
    trail = [_headers(lc)]
    for period, update in chain["updates"].items():
        trail.append(_step(pkg, lc, lc.process_update, from_json(update)))
        trail.append(_headers(lc))
    trail.append(_step(pkg, lc, lc.process_finality_update, from_json(chain["finality"])))
    trail.append(_step(pkg, lc, lc.process_optimistic_update, from_json(chain["optimistic"])))
    trail.append(_headers(lc))
    # tampered: no participation, a changed attested state root; and a
    # stale update, period 0's once more
    bad = from_json(chain["updates"][2])
    bad.sync_aggregate.sync_committee_bits = [False] * len(bad.sync_aggregate.sync_committee_bits)
    trail.append(_step(pkg, lc, lc.process_update, bad))
    bad = from_json(chain["updates"][2])
    bad.attested_header.state_root = b"\x13" * 32
    trail.append(_step(pkg, lc, lc.process_update, bad))
    trail.append(_step(pkg, lc, lc.process_update, from_json(chain["updates"][0])))
    trail.append(_headers(lc))
    return trail


def test_following_finality_reaches_the_jax_clients_headers(chain):
    got = _follow("port", chain)
    assert got == _follow("jax", chain)
    final = got[-1]
    assert final["finalized"][0] // PERIOD == 2 and final["optimistic"][0] > 2 * PERIOD
    assert sum(s.startswith("refused") for s in got if isinstance(s, str)) >= 2


def _forced(pkg: str, chain: dict) -> list:
    lc, from_json = _client(pkg, chain)
    boot_slot = int(lc.finalized_header.slot)
    u0 = from_json(chain["updates"][0])
    u0.finalized_header = mod(pkg, "ssz").Fields(slot=0, proposer_index=0,
                                                  parent_root=b"\x00" * 32,
                                                  state_root=b"\x00" * 32, body_root=b"\x00" * 32)
    timeout = mod(pkg, "params").MINIMAL.UPDATE_TIMEOUT
    trail = [_step(pkg, lc, lc.process_update, u0), _headers(lc),
             lc.best_valid_update is not None,
             lc.force_update(boot_slot + timeout), _headers(lc),
             lc.force_update(boot_slot + timeout + 1), _headers(lc),
             lc.next_sync_committee is not None,
             _step(pkg, lc, lc.process_update, from_json(chain["updates"][1])), _headers(lc)]
    return trail


def test_two_period_gap_and_forced_advance_equal_the_jax_clients(chain):
    got = _forced("port", chain)
    assert got == _forced("jax", chain)
    assert got[2] is True and got[3] is False and got[5] is True
    assert got[4] == got[1] and got[6]["finalized"] != got[1]["finalized"]
    assert got[-1]["finalized"][0] // PERIOD >= 1


def test_update_ssz_round_trip_keeps_signature_slot_as_the_jax_type(chain):
    out = {}
    for pkg in PKGS:
        from_json = mod(pkg, "api.serde").from_json
        typ = mod(pkg, "types").get_types(mod(pkg, "params").MINIMAL).altair.LightClientUpdate
        update = from_json(chain["updates"][1])
        blob = typ.serialize(update)
        back = typ.deserialize(blob)
        lc, _ = _client(pkg, chain)
        out[pkg] = (blob, int(back.signature_slot), lc._signature_slot(back),
                    typ.hash_tree_root(back))
    assert out["port"] == out["jax"]
    assert out["port"][1] == out["port"][2] > 0
