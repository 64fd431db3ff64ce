"""The MEV builder flow on the port against the JAX package's
(``tests/test_builder_flow.py``'s cases): the proposer cache, blinded and
full bodies merkleizing alike and the unblind refusing a tampered payload,
the mock builder's registration checks, and a blinded proposal through
the chain (registrations signed directly under the builder domain, as
the JAX test's validator store signs them; the port's
``ValidatorStore.sign_validator_registration`` is held to the JAX
store's bytes in ``tests/test_torch_validator_store.py``).  Every outcome, the imported head root and the fee recipient in the
payload included, equals the JAX package's."""

import asyncio
import importlib

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
FEE = b"\xfe" * 20


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def cfg(pkg):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", MIN_GENESIS_TIME=0, SHARD_COMMITTEE_PERIOD=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16, ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=2)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_proposer_cache_add_prune_get(pkg):
    cache = mod(pkg, "chain.beacon_proposer_cache").BeaconProposerCache(
        default_fee_recipient=b"\xaa" * 20)
    cache.add(5, 7, b"\xbb" * 20)
    assert cache.get(7) == b"\xbb" * 20 and cache.get(8) == b"\xaa" * 20
    cache.prune(6)
    assert cache.get(7) == b"\xbb" * 20
    cache.prune(9)
    assert cache.get(7) == b"\xaa" * 20


def blinded_roots(pkg: str) -> dict:
    p, b = mod(pkg, "params").MINIMAL, mod(pkg, "execution.builder")
    Fields = mod(pkg, "ssz").Fields
    t = mod(pkg, "types").get_types(p).bellatrix
    engine = mod(pkg, "execution.engine").ExecutionEngineMock(p, genesis_block_hash=b"\x22" * 32)
    pid = engine.notify_forkchoice_update(
        b"\x22" * 32, b"\x22" * 32, b"\x22" * 32,
        Fields(timestamp=12, prev_randao=b"\x03" * 32, suggested_fee_recipient=b"\x04" * 20))
    payload = engine.get_payload(pid)
    body = t.BeaconBlockBody.default()
    body.execution_payload = payload
    blinded = b.blind_body(p, body)
    full_root = bytes(t.BeaconBlockBody.hash_tree_root(body))
    assert full_root == bytes(t.BlindedBeaconBlockBody.hash_tree_root(blinded))
    signed_blinded = Fields(message=Fields(slot=1, proposer_index=0, parent_root=b"\x00" * 32,
                                           state_root=b"\x00" * 32, body=blinded),
                            signature=b"\x00" * 96)
    signed = b.unblind_block(p, signed_blinded, payload)
    assert bytes(t.BeaconBlockBody.hash_tree_root(signed.message.body)) == full_root
    wrong = Fields(**{k: payload[k] for k in payload.keys()})
    wrong.block_number = payload.block_number + 1
    with pytest.raises(ValueError, match="does not match"):
        b.unblind_block(p, signed_blinded, wrong)
    header = b.payload_to_header(p, payload)
    return dict(root=full_root, header=bytes(t.ExecutionPayloadHeader.hash_tree_root(header)))


def test_blinded_block_roots_match_full_as_in_the_jax_package():
    assert blinded_roots("port") == blinded_roots("jax")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_builder_mock_registration_checks(pkg):
    p = mod(pkg, "params").MINIMAL
    Fields = mod(pkg, "ssz").Fields
    key = mod(pkg, "crypto.bls.api").interop_secret_key
    builder = mod(pkg, "execution.builder").ExecutionBuilderMock(
        p, mod(pkg, "execution.engine").ExecutionEngineMock(p))
    with pytest.raises(ValueError, match="not registered"):
        builder.get_header(1, b"\x00" * 32, b"\xab" * 48)
    reg = Fields(message=Fields(fee_recipient=b"\x01" * 20, gas_limit=30_000_000, timestamp=1,
                                pubkey=key(0).to_public_key().to_bytes()),
                 signature=key(1).sign(b"\x00" * 32).to_bytes())
    with pytest.raises(ValueError, match="invalid validator registration"):
        builder.register_validator([reg])


def blinded_proposal(pkg: str) -> dict:
    """A post-merge dev chain; every validator registers with the mock
    builder; a blinded block is produced, signed and published; the chain
    unblinds it through the builder and imports the full block."""
    p, c = mod(pkg, "params"), cfg(pkg)
    minimal, Fields, st = p.MINIMAL, mod(pkg, "ssz").Fields, mod(pkg, "state_transition")
    engine = mod(pkg, "execution.engine").ExecutionEngineMock(minimal,
                                                              genesis_block_hash=b"\x11" * 32)
    pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.001)
    dev = mod(pkg, "node.dev_chain").DevChain(minimal, c, 16, pool, execution_engine=engine)
    builder = mod(pkg, "execution.builder").ExecutionBuilderMock(
        minimal, engine, fork_version=c.GENESIS_FORK_VERSION)
    dev.chain.builder = builder
    t_be = mod(pkg, "types").get_types(minimal).bellatrix
    domain = st.compute_domain(minimal, p.DOMAIN_APPLICATION_BUILDER, c.GENESIS_FORK_VERSION,
                               b"\x00" * 32)

    async def run():
        for slot in range(1, 18):  # across the merge (Bellatrix at 16)
            await dev.advance_slot(slot)
        regs = []
        for i, sk in dev.keys.items():
            msg = Fields(fee_recipient=FEE, gas_limit=30_000_000, timestamp=1,
                         pubkey=sk.to_public_key().to_bytes())
            root = st.compute_signing_root(minimal, t_be.ValidatorRegistrationV1, msg, domain)
            regs.append(Fields(message=msg, signature=sk.sign(root).to_bytes()))
        builder.register_validator(regs)
        for i in dev.keys:
            dev.chain.beacon_proposer_cache.add(0, i, FEE)
        slot = 18
        dev.clock.set_slot(slot)
        pre = st.clone_state(minimal, dev.chain.head_state())
        proposer = st.process_slots(minimal, c, pre, slot).get_beacon_proposer(slot)
        randao = dev._sign_randao(pre, proposer, st.compute_epoch_at_slot(minimal, slot))
        block, prop2 = await dev.chain.produce_blinded_block(slot, randao)
        assert prop2 == proposer and "execution_payload_header" in block.body
        signed = Fields(message=block, signature=dev._sign_block(pre, block, proposer))
        return await dev.chain.publish_blinded_block(signed)

    root = asyncio.run(run())
    assert dev.chain.head_root == root
    state = dev.chain.head_state()
    hdr = state.latest_execution_payload_header
    assert bytes(hdr.fee_recipient) == FEE and state.slot == 18
    with pytest.raises(mod(pkg, "chain.beacon_chain").BlockError, match="no builder"):
        dev.chain.builder = None
        asyncio.run(dev.chain.produce_blinded_block(19, b"\x00" * 96))
    pool.close()
    return dict(root=root, block_hash=bytes(hdr.block_hash), fee=bytes(hdr.fee_recipient))


def test_blinded_proposal_through_the_chain_equals_the_jax_chains():
    assert blinded_proposal("port") == blinded_proposal("jax")
