"""The key surface the chain signs and aggregates with: the port's
``crypto/bls/api.py`` over its native ``fastbls`` entries gives the JAX
package's bytes and verdicts for seeded keys and messages."""

import numpy as np
import pytest

from lodestar_tpu.crypto.bls import api as J
from lodestar_tpu_torch.crypto.bls import api as P
from lodestar_tpu_torch.native import fastbls

SEED = 1818
N = 8


def _keys_and_msgs():
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "big") % (J.R - 1) + 1 for _ in range(N)]
    msgs = [rng.bytes(int(rng.integers(0, 80))) for _ in range(N)]
    return scalars, msgs


SCALARS, MSGS = _keys_and_msgs()


@pytest.mark.parametrize("i", range(N))
@pytest.mark.parametrize("variable_time", [False, True])
def test_sign_gives_the_jax_bytes_in_both_modes(i, variable_time):
    want = J.SecretKey(SCALARS[i]).sign(MSGS[i], variable_time=variable_time).to_bytes()
    got = P.SecretKey(SCALARS[i]).sign(MSGS[i], variable_time=variable_time).to_bytes()
    assert got == want
    # and the bigint ladder's, the oracle both native ladders are held to
    assert got == P.Signature(P.hash_to_g2(MSGS[i]) * SCALARS[i]).to_bytes()


@pytest.mark.parametrize("i", range(N))
def test_to_public_key_gives_the_jax_bytes(i):
    got = P.SecretKey(SCALARS[i]).to_public_key()
    assert got.to_bytes() == J.SecretKey(SCALARS[i]).to_public_key().to_bytes()
    assert got.to_bytes() == P.PublicKey(P.G1_GEN * SCALARS[i]).to_bytes()


def test_interop_pubkeys_are_the_jax_packages():
    assert P.interop_pubkeys(N) == J.interop_pubkeys(N)


@pytest.mark.parametrize("k", [1, 3, N])
def test_sign_aggregate_and_aggregate_signatures_give_the_jax_bytes(k):
    msg = MSGS[k - 1]
    jsks, psks = [J.SecretKey(s) for s in SCALARS[:k]], [P.SecretKey(s) for s in SCALARS[:k]]
    want = J.sign_aggregate(jsks, msg).to_bytes()
    assert P.sign_aggregate(psks, msg).to_bytes() == want
    # aggregation of compressed signatures (C) and of points (jacobian)
    sigs = [sk.sign(msg) for sk in psks]
    assert P.aggregate_signatures(sigs).to_bytes() == want
    points = [P.Signature(s.point) for s in sigs]
    assert P.aggregate_signatures(points).to_bytes() == want
    jsigs = [J.Signature(raw=s.to_bytes()) for s in sigs]
    assert J.aggregate_signatures(jsigs).to_bytes() == want
    # public keys likewise, raw and as points
    pks = [sk.to_public_key() for sk in psks]
    jpk = J.aggregate_pubkeys([sk.to_public_key() for sk in jsks]).to_bytes()
    assert P.aggregate_pubkeys(pks).to_bytes() == jpk
    assert P.aggregate_pubkeys([P.PublicKey(pk.point) for pk in pks]).to_bytes() == jpk


def test_fast_aggregate_verify_verdicts_equal_the_jax_packages():
    msg = MSGS[2]
    psks = [P.SecretKey(s) for s in SCALARS[:4]]
    sig = P.sign_aggregate(psks, msg)
    cases = [
        ([sk.to_public_key() for sk in psks], msg, sig),                # valid
        ([sk.to_public_key() for sk in psks], msg + b"!", sig),         # other message
        ([sk.to_public_key() for sk in psks[:3]], msg, sig),            # a signer missing
        ([], msg, sig),                                                 # no signers
    ]
    verdicts = []
    for pks, m, s in cases:
        got = P.fast_aggregate_verify(pks, m, s)
        want = J.fast_aggregate_verify([J.PublicKey(raw=pk.to_bytes()) for pk in pks], m,
                                       J.Signature(raw=s.to_bytes()))
        assert got == want
        verdicts.append(got)
    assert verdicts == [True, False, False, False]


def test_aggregate_verify_verdicts_equal_the_jax_packages():
    psks = [P.SecretKey(s) for s in SCALARS[:3]]
    msgs = MSGS[:3]
    sig = P.aggregate_signatures([sk.sign(m) for sk, m in zip(psks, msgs)])
    pks = [sk.to_public_key() for sk in psks]
    cases = [
        (pks, msgs, sig),                                  # valid
        (pks, [msgs[0], msgs[2], msgs[1]], sig),           # messages swapped
        (pks[:2], msgs[:2], sig),                          # a pair missing
        (pks, msgs[:2], sig),                              # lengths differ
    ]
    verdicts = []
    for k, m, s in cases:
        got = P.aggregate_verify(k, m, s)
        want = J.aggregate_verify([J.PublicKey(raw=pk.to_bytes()) for pk in k], m,
                                  J.Signature(raw=s.to_bytes()))
        assert got == want
        verdicts.append(got)
    assert verdicts == [True, False, False, False]


def test_native_key_entries_refuse_what_the_library_refuses():
    with pytest.raises(ValueError):
        fastbls.sign(b"\x00" * 32, b"m")  # the scalar 0
    with pytest.raises(ValueError):
        fastbls.sk_to_pk(b"\x01" * 31)
    assert fastbls.sign_aggregate([], b"m") is None
    # a 48-byte string that is no point of E1 (its x is not below p) is
    # refused, and the api then decompresses it, which raises as the JAX
    # package's does
    bad = b"\x9f" + b"\xff" * 47
    assert fastbls.aggregate_pks([bad]) is None
    with pytest.raises(ValueError):
        P.aggregate_pubkeys([P.PublicKey(raw=bad)])
    with pytest.raises(ValueError):
        J.aggregate_pubkeys([J.PublicKey(raw=bad)])
