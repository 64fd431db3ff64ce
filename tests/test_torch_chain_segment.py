"""Range sync's ``process_chain_segment`` on both packages, with equal
outcomes: ``tests/test_chain_segment.py``'s three cases (the segment in one
batch, the valid prefix before a bad block and its ``BlockError``, an
unknown parent) over each package's ``BlsBatchPool`` and
``FastBlsVerifier``, 16 interop validators in phase0."""

import asyncio

import pytest

from lodestar_tpu.chain.beacon_chain import BlockError as JBlockError
from lodestar_tpu.chain.bls_pool import BlsBatchPool as JPool
from lodestar_tpu.config.chain_config import ChainConfig as JChainConfig
from lodestar_tpu.crypto.bls.native_verifier import FastBlsVerifier as JFast
from lodestar_tpu.node.dev_chain import DevChain as JDevChain
from lodestar_tpu.params import MINIMAL as J_MINIMAL
from lodestar_tpu.ssz import Fields as JFields
from lodestar_tpu.state_transition.upgrade import block_types as j_block_types
from lodestar_tpu_torch.chain.beacon_chain import BlockError as PBlockError
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool as PPool
from lodestar_tpu_torch.config.chain_config import ChainConfig as PChainConfig
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier as PFast
from lodestar_tpu_torch.node.dev_chain import DevChain as PDevChain
from lodestar_tpu_torch.params import MINIMAL as P_MINIMAL
from lodestar_tpu_torch.ssz import Fields as PFields
from lodestar_tpu_torch.state_transition.upgrade import block_types as p_block_types

PHASE0 = dict(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
              MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16, ALTAIR_FORK_EPOCH=2**64 - 1,
              BELLATRIX_FORK_EPOCH=2**64 - 1)


class _Counting:
    """A verifier's batch count, for one package's FastBlsVerifier."""

    def __init__(self, base):
        self.base = base()
        self.batches = []

    def verify_signature_sets(self, sets):
        self.batches.append(len(sets))
        return self.base.verify_signature_sets(sets)


PACKAGES = {
    "jax": dict(pool=JPool, fast=JFast, dev=JDevChain, preset=J_MINIMAL,
                cfg=JChainConfig(**PHASE0), error=JBlockError, fields=JFields,
                block_types=j_block_types),
    "port": dict(pool=PPool, fast=PFast, dev=PDevChain, preset=P_MINIMAL,
                 cfg=PChainConfig(**PHASE0), error=PBlockError, fields=PFields,
                 block_types=p_block_types),
}


def _build_segment(pkg, n_slots):
    async def run():
        pool = pkg["pool"](_Counting(pkg["fast"]), max_buffer_wait=0.005)
        producer = pkg["dev"](pkg["preset"], pkg["cfg"], 16, pool)
        seg = []
        for slot in range(1, 1 + n_slots):
            root = await producer.advance_slot(slot)
            seg.append(producer.chain.get_block_by_root(root))
        pool.close()
        return seg, producer.chain.head_root

    return asyncio.run(run())


def _consume(pkg, seg):
    """Import ``seg`` on a fresh chain: (imported, head, segment batches,
    error type or None, roots known to fork choice, re-import count)."""
    async def run():
        verifier = _Counting(pkg["fast"])
        pool = pkg["pool"](verifier, max_buffer_wait=0.005)
        consumer = pkg["dev"](pkg["preset"], pkg["cfg"], 16, pool)
        error, n, again = None, None, None
        try:
            n = await consumer.chain.process_chain_segment(seg)
            again = await consumer.chain.process_chain_segment(seg)
        except pkg["error"] as e:
            error = type(e)
        known = [consumer.chain.fork_choice.has_block(
            pkg["block_types"](pkg["preset"], sb.message).BeaconBlock.hash_tree_root(sb.message))
            for sb in seg]
        pool.close()
        return dict(n=n, again=again, head=consumer.chain.head_root, batches=verifier.batches,
                    error=error, known=known,
                    head_is_fork_choice=consumer.chain.head_root
                    == consumer.chain.fork_choice.update_head())

    return asyncio.run(run())


def test_segment_imports_in_one_batch_on_both_packages():
    out = {}
    for name, pkg in PACKAGES.items():
        seg, producer_head = _build_segment(pkg, 6)
        out[name] = _consume(pkg, seg)
        assert out[name]["head"] == producer_head
    j, p = out["jax"], out["port"]
    assert p["n"] == j["n"] == 6 and p["again"] == j["again"] == 0
    assert len(p["batches"]) == len(j["batches"]) == 1
    assert p["batches"] == j["batches"] and p["head"] == j["head"]
    assert p["error"] is j["error"] is None and p["head_is_fork_choice"]


def test_segment_bad_block_imports_the_valid_prefix_on_both_packages():
    out = {}
    for name, pkg in PACKAGES.items():
        seg, _ = _build_segment(pkg, 5)
        bad = pkg["fields"](message=seg[3].message, signature=b"\xaa" * 96)
        out[name] = _consume(pkg, seg[:3] + [bad] + seg[4:])
    j, p = out["jax"], out["port"]
    assert j["error"] is JBlockError and p["error"] is PBlockError
    assert p["known"] == j["known"] == [True, True, True, False, False]
    assert p["batches"] == j["batches"] and p["head"] == j["head"]


def test_segment_unknown_parent_raises_on_both_packages():
    for pkg in PACKAGES.values():
        seg, _ = _build_segment(pkg, 4)
        out = _consume(pkg, seg[2:])
        assert out["error"] is pkg["error"] and out["batches"] == []
        assert out["known"] == [False, False]


@pytest.mark.parametrize("n_slots", [1, 3])
def test_segments_of_both_packages_are_the_same_blocks(n_slots):
    jseg, jhead = _build_segment(PACKAGES["jax"], n_slots)
    pseg, phead = _build_segment(PACKAGES["port"], n_slots)
    assert phead == jhead
    for jb, pb in zip(jseg, pseg):
        jt = j_block_types(J_MINIMAL, jb.message).SignedBeaconBlock
        pt = p_block_types(P_MINIMAL, pb.message).SignedBeaconBlock
        assert pt.serialize(pb) == jt.serialize(jb)
