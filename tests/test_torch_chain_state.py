"""The state crosses between the packages as SSZ bytes: the port's SSZ
codec, type schemas and interop genesis give the JAX package's bytes and
roots, and a JAX state's bytes, deserialized by the port, have the same
root (the way a node takes a checkpoint state).  Every comparison is by
bytes or by root."""

import pytest

from lodestar_tpu import ssz as jssz
from lodestar_tpu.config.chain_config import ChainConfig as JChainConfig
from lodestar_tpu.params import MAINNET as J_MAINNET, MINIMAL as J_MINIMAL
from lodestar_tpu.state_transition.genesis import interop_genesis_state as j_genesis
from lodestar_tpu.types import get_types as j_types
from lodestar_tpu_torch import ssz as pssz
from lodestar_tpu_torch.config.chain_config import ChainConfig as PChainConfig
from lodestar_tpu_torch.params import MAINNET as P_MAINNET, MINIMAL as P_MINIMAL
from lodestar_tpu_torch.state_transition.genesis import interop_genesis_state as p_genesis
from lodestar_tpu_torch.types import get_types as p_types

PRESETS = {"minimal": (J_MINIMAL, P_MINIMAL), "mainnet": (J_MAINNET, P_MAINNET)}
FORKS = ("phase0", "altair", "bellatrix")


def _cfgs(base: str, n: int):
    kw = dict(PRESET_BASE=base, MIN_GENESIS_TIME=0, MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=n)
    return JChainConfig(**kw), PChainConfig(**kw)


@pytest.mark.parametrize("base", sorted(PRESETS))
@pytest.mark.parametrize("n", [16, 32, 128])
def test_interop_genesis_states_serialize_to_equal_bytes(base, n):
    jp, pp = PRESETS[base]
    jcfg, pcfg = _cfgs(base, n)
    js, ps = j_genesis(jp, jcfg, n, 1), p_genesis(pp, pcfg, n, 1)
    jt, pt = j_types(jp).phase0.BeaconState, p_types(pp).phase0.BeaconState
    blob = jt.serialize(js)
    assert pt.serialize(ps) == blob
    assert pt.hash_tree_root(ps) == jt.hash_tree_root(js)
    # the JAX state's bytes, read by the port: the same root and bytes
    back = pt.deserialize(blob)
    assert pt.hash_tree_root(back) == jt.hash_tree_root(js)
    assert pt.serialize(back) == blob


@pytest.mark.parametrize("base", sorted(PRESETS))
@pytest.mark.parametrize("fork", FORKS)
def test_default_states_and_blocks_cross_as_bytes(base, fork):
    jp, pp = PRESETS[base]
    for name in ("BeaconState", "SignedBeaconBlock", "Attestation"):
        jt, pt = getattr(getattr(j_types(jp), fork), name), getattr(getattr(p_types(pp), fork), name)
        blob = jt.serialize(jt.default())
        assert pt.serialize(pt.default()) == blob, name
        back = pt.deserialize(blob)
        assert pt.serialize(back) == blob, name
        assert pt.hash_tree_root(back) == jt.hash_tree_root(jt.default()), name


def _values(m):
    """test_ssz.py's values, as (type, value) pairs built from module m."""
    inner = m.Container("Inner", [("a", m.uint64), ("b", m.List(m.uint8, 10))])
    return [
        (m.uint8, 0x7F), (m.uint16, 0xABCD), (m.uint64, 2**64 - 1), (m.uint256, 3**100),
        (m.boolean, True), (m.boolean, False),
        (m.Vector(m.uint64, 4), [1, 2, 3, 4]), (m.Vector(m.uint64, 8), list(range(8))),
        (m.List(m.uint64, 1024), [7, 8, 9]), (m.List(m.Bytes32, 4), []),
        (m.List(inner, 4), [m.Fields(a=1, b=b"\x01\x02"), m.Fields(a=2, b=b"")]),
        (m.Bitvector(10), [True, False] * 5),
        *((m.Bitlist(16), [bool(i % 3 == 0) for i in range(n)]) for n in (0, 1, 7, 8, 9, 16)),
        (m.Container("T", [("a", m.uint64), ("b", m.Bytes32)]), m.Fields(a=42, b=b"\x11" * 32)),
        (m.Container("T", [("a", m.uint64), ("b", m.List(m.uint8, 100)), ("c", m.uint16)]),
         m.Fields(a=1, b=b"\xaa\xbb\xcc", c=9)),
        (m.Union([None, m.uint64, m.Bytes32]), (0, None)),
        (m.Union([None, m.uint64, m.Bytes32]), (1, 77)),
        (m.Union([None, m.uint64, m.Bytes32]), (2, b"\x05" * 32)),
    ]


@pytest.mark.parametrize("i", range(len(_values(jssz))))
def test_ssz_round_trips_give_the_jax_bytes_and_roots(i):
    (jt, jv), (pt, pv) = _values(jssz)[i], _values(pssz)[i]
    blob = jt.serialize(jv)
    assert pt.serialize(pv) == blob
    assert pt.hash_tree_root(pv) == jt.hash_tree_root(jv)
    back = pt.deserialize(blob)
    assert pt.serialize(back) == blob
    assert pt.hash_tree_root(back) == jt.hash_tree_root(jv)


def test_merkleization_equals_the_jax_packages():
    chunks = [bytes([i]) * 32 for i in range(37)]
    for limit in (None, 37, 64, 2**20):
        assert pssz.merkleize(chunks, limit) == jssz.merkleize(chunks, limit)
    assert pssz.merkleize([], 4) == jssz.merkleize([], 4)
    assert pssz.pack_bytes(b"\x01" * 70) == jssz.pack_bytes(b"\x01" * 70)


def test_layer_hash_is_the_c_copy_and_a_failed_build_raises(monkeypatch):
    """The port hashes merkle layers in its copy of hashtree.c (byte for
    byte the JAX package's), checked against hashlib; a build that fails
    raises at the first hash, and again, with no hashlib fallback."""
    import hashlib
    import os

    from lodestar_tpu_torch.native import fastbls, hashtree

    here = os.path.dirname(hashtree.__file__)
    repo = os.path.dirname(os.path.dirname(here))
    with open(os.path.join(here, "hashtree.c"), "rb") as a, \
            open(os.path.join(repo, "csrc", "hashtree.c"), "rb") as b:
        assert a.read() == b.read()
    data = bytes(range(256)) * 2
    want = b"".join(hashlib.sha256(data[i:i + 64]).digest() for i in range(0, len(data), 64))
    assert hashtree.hash_layer(data) == want
    assert hashtree.build().startswith(fastbls.BUILD_DIR)

    monkeypatch.setattr(hashtree, "build", lambda cc=None: fastbls.build(
        "false", stem="hashtree", sources=hashtree.SOURCES))
    monkeypatch.setattr(hashtree, "_lib", None)
    monkeypatch.setattr(hashtree, "_error", None)
    for _ in range(2):  # the first failure is kept, not retried
        with pytest.raises(RuntimeError):
            pssz.merkleize([b"\x01" * 32, b"\x02" * 32])
    assert hashtree._lib is None
