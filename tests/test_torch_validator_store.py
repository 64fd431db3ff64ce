"""The port's ``ValidatorStore`` and ``SlashingProtection`` against the JAX
package's.  Every signing method (randao, block of each fork and a
blinded one, attestation, selection proof, aggregate-and-proof, sync
message, sync selection proof, contribution, voluntary exit, builder
registration) gives the JAX store's bytes under Altair at epoch 1 and
Bellatrix at 2, at the last slot of epochs 0 and 1 and the first slot of
epochs 1 and 2, with ``dev_signing`` on and off.  Slashing protection:
one seeded sequence of proposals and votes (double votes, surrounds in
both directions, identical re-signs) is refused or accepted alike with
the same message, the interchange exports are equal JSON, a file and a
write-ahead log written by either package (cleanly closed, or dropped
without a close as a crash) are read by the other to the same history.
Exact bytes and JSON throughout; seconds on one core."""

import importlib
import json

import numpy as np
import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N_KEYS = 4
# the last slot of epochs 0 and 1 and the first of epochs 1 and 2: the
# fork edges of Altair at 1 and Bellatrix at 2
EDGE_SLOTS = (7, 8, 15, 16)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _store(pkg: str, dev_signing: bool, protection=None):
    cfg = mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", MIN_GENESIS_TIME=0, SHARD_COMMITTEE_PERIOD=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16, ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=2)
    bls = mod(pkg, "crypto.bls.api")
    return mod(pkg, "validator").ValidatorStore(
        mod(pkg, "params").MINIMAL, cfg, {i: bls.interop_secret_key(i) for i in range(N_KEYS)},
        protection, genesis_validators_root=bytes(range(32)), dev_signing=dev_signing)


def _block(pkg: str, slot: int, blinded: bool = False):
    types = mod(pkg, "types").get_types(mod(pkg, "params").MINIMAL)
    fork = "phase0" if slot < 8 else "altair" if slot < 16 else "bellatrix"
    t = getattr(types, fork)
    block = (t.BlindedBeaconBlock if blinded else t.BeaconBlock).default()
    block.slot, block.proposer_index = slot, slot % N_KEYS
    block.parent_root, block.state_root = bytes([slot]) * 32, bytes([slot + 1]) * 32
    block.body.graffiti = b"validator store" + bytes(17)
    return block


def _signatures(pkg: str, dev_signing: bool) -> list:
    F = mod(pkg, "ssz").Fields
    store = _store(pkg, dev_signing)
    out = []
    for slot in EDGE_SLOTS:
        epoch, vi = slot // 8, slot % N_KEYS
        data = F(slot=slot, index=1, beacon_block_root=bytes([slot]) * 32,
                 source=F(epoch=max(0, epoch - 1), root=b"\x04" * 32),
                 target=F(epoch=epoch, root=bytes([slot + 2]) * 32))
        agg = F(aggregation_bits=[True, False, True], data=data,
                signature=b"\xc0" + b"\x00" * 95)
        contribution = F(slot=slot, beacon_block_root=b"\x03" * 32, subcommittee_index=2,
                         aggregation_bits=[i % 3 == 0 for i in range(8)],
                         signature=b"\xc0" + b"\x00" * 95)
        sync = [
            store.sign_sync_committee_message(vi, slot, bytes([slot]) * 32).signature,
            store.sign_sync_selection_proof(vi, slot, 2),
            store.sign_contribution_and_proof(vi, F(aggregator_index=vi,
                                                    contribution=contribution,
                                                    selection_proof=b"\x22" * 96)),
        ] if epoch >= 1 else []
        out += [
            ("randao", slot, store.sign_randao(vi, epoch)),
            ("block", slot, store.sign_block(vi, _block(pkg, slot))),
            ("attestation", slot, store.sign_attestation(vi, data)),
            ("selection_proof", slot, store.sign_selection_proof(vi, slot)),
            ("aggregate_and_proof", slot, store.sign_aggregate_and_proof(
                vi, F(aggregator_index=vi, aggregate=agg, selection_proof=b"\x11" * 96))),
            ("voluntary_exit", slot, store.sign_voluntary_exit(vi, epoch).signature),
            ("registration", slot, store.sign_validator_registration(
                vi, bytes([slot]) * 20, 30_000_000 + slot, 1_600_000_000 + slot).signature),
        ] + [(name, slot, sig) for name, sig in zip(
            ("sync_message", "sync_selection_proof", "contribution_and_proof"), sync)]
    # the blinded block signs the root of its full counterpart: another
    # proposer and slot, or protection would refuse the second proposal
    out.append(("blinded_block", 17, store.sign_block(1, _block(pkg, 17, blinded=True))))
    return [(name, slot, bytes(sig)) for name, slot, sig in out]


@pytest.mark.parametrize("dev_signing", [False, True])
def test_every_signature_equals_the_jax_stores_across_the_fork_edges(dev_signing):
    got, want = _signatures("port", dev_signing), _signatures("jax", dev_signing)
    assert len(got) == 38 and got == want
    # the three fork versions give three domains, the JAX store's
    params = {pkg: mod(pkg, "params") for pkg in PKGS}
    domains = {pkg: [_store(pkg, dev_signing)._domain(params[pkg].DOMAIN_RANDAO, e)
                     for e in range(3)] for pkg in PKGS}
    assert domains["port"] == domains["jax"] and len(set(domains["port"])) == 3


def test_dev_signing_gives_the_constant_time_paths_bytes():
    assert _signatures("port", True) == _signatures("port", False)


def _operations(seed: int, n: int = 120):
    """A seeded mix of proposals and votes over two keys, many of them
    slashable: (kind, pubkey, a, b, root)."""
    rng = np.random.default_rng(seed)
    pubkeys = [bytes([0x11]) * 48, bytes([0x22]) * 48]
    ops = []
    for _ in range(n):
        pk = pubkeys[rng.integers(2)]
        root = bytes([rng.integers(3)]) * 32
        if rng.random() < 0.3:
            ops.append(("block", pk, int(rng.integers(0, 12)), None, root))
        else:
            source = int(rng.integers(0, 8))
            ops.append(("attestation", pk, source, source + int(rng.integers(-1, 5)), root))
    return ops


def _apply(pkg: str, ops, protection) -> list:
    error = mod(pkg, "validator").SlashingError
    out = []
    for kind, pk, a, b, root in ops:
        try:
            if kind == "block":
                protection.check_and_insert_block_proposal(pk, a, root)
            else:
                protection.check_and_insert_attestation(pk, a, b, root)
            out.append("ok")
        except error as e:
            out.append(str(e))
    return out


def test_refusals_and_the_interchange_equal_the_jax_class():
    ops = _operations(20)
    protections = {pkg: mod(pkg, "validator").SlashingProtection(b"\x07" * 32) for pkg in PKGS}
    outcomes = {pkg: _apply(pkg, ops, protections[pkg]) for pkg in PKGS}
    assert outcomes["port"] == outcomes["jax"]
    assert 10 < outcomes["port"].count("ok") < len(ops) - 10  # both kinds of answer
    exported = {pkg: protections[pkg].export_json() for pkg in PKGS}
    assert exported["port"] == exported["jax"]
    # each package imports the other's interchange to the same refusals
    for src, dst in (("jax", "port"), ("port", "jax")):
        back = mod(dst, "validator").SlashingProtection(b"\x07" * 32)
        back.import_json(exported[src])
        assert back.export_json() == exported[src]
        assert _apply(dst, ops, back) == _apply(src, ops,
                                                _reloaded(src, exported[src]))


def _reloaded(pkg: str, raw: str):
    p = mod(pkg, "validator").SlashingProtection(b"\x07" * 32)
    p.import_json(raw)
    return p


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("closed", [True, False], ids=["closed", "crashed"])
def test_files_and_the_write_ahead_log_cross_the_packages(tmp_path, writer, reader, closed):
    path = str(tmp_path / "protection.json")
    ops = _operations(21, n=40)
    first = mod(writer, "validator").SlashingProtection(persist_path=path)
    _apply(writer, ops[:30], first)
    if closed:
        first.close()  # folds the log into the interchange file
        assert open(path + ".wal").read() == ""
    else:
        # a crash: no close, no checkpoint; the log alone holds the history
        first._wal.close()
        assert open(path + ".wal").read().count("\n") > 0
    want = first.export_json()
    second = mod(reader, "validator").SlashingProtection(persist_path=path)
    assert second.export_json() == want
    # the rest of the sequence is refused or accepted as by the writer's
    # own reload
    third = mod(writer, "validator").SlashingProtection()
    third.import_json(want)
    assert _apply(reader, ops[30:], second) == _apply(writer, ops[30:], third)
    second.close()
    assert json.loads(open(path).read()) == json.loads(third.export_json())


def test_a_torn_last_log_line_is_dropped_alike(tmp_path):
    path = str(tmp_path / "protection.json")
    p = mod("port", "validator").SlashingProtection(persist_path=path)
    p.check_and_insert_attestation(b"\x33" * 48, 1, 2, b"\xaa" * 32)
    p._wal.close()
    with open(path + ".wal", "a") as f:
        f.write('{"kind": "attestation", "pubkey": "33')  # cut mid-record
    got = {pkg: mod(pkg, "validator").SlashingProtection(persist_path=path).export_json()
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"] and "0x" + "33" * 48 in got["port"]
