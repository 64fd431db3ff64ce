"""The plain reference's verdicts on a tiny batch, one good set and one
bad, held against the pure-Python pairing (``portbench/pyref``, a frozen
copy of the JAX package's bigint oracle); the random linear combination
of the stand-in verifier with and without coefficients on a cancelling
pair."""

from portbench import bank, harness, traffic
from portbench.pyref import check as pyref_check
from portbench.pyref.curve import g1_from_bytes, g2_from_bytes
from portbench.pyref.fields import R
from portbench.pyref.hash_to_curve import hash_to_g2
from portbench.pyref.pairing import multi_pairing
from portbench.pyref.curve import G1_GEN


def _oracle(pk: bytes, root: bytes, sig: bytes) -> bool:
    return multi_pairing([(-G1_GEN, g2_from_bytes(sig)),
                          (g1_from_bytes(pk), hash_to_g2(root))]).is_one()


def test_reference_one_good_one_bad():
    root_a, root_b = b"\x01" * 32, b"\x02" * 32
    sig_a = bank.sign(bank.interop_sk(3), root_a)
    sig_wrong = bank.sign(bank.interop_sk(3), root_b)  # the key signed another root
    got = bank.verify_tasks([((3,), root_a, sig_a), ((3,), root_a, sig_wrong)])
    assert got == [True, False]
    pk = bank.sk_to_pk(bank.interop_sk(3))
    assert [_oracle(pk, root_a, sig_a), _oracle(pk, root_a, sig_wrong)] == [True, False]


def test_reference_aggregate_from_secret_keys():
    keys = (1, 5, 9)
    root = b"\x07" * 32
    sig = bank.sign_sum([bank.interop_sk(k) for k in keys], root)
    assert bank.verify_tasks([(keys, root, sig), (keys[:2], root, sig)]) == [True, False]
    pks = [bank.sk_to_pk(bank.interop_sk(k)) for k in keys]
    agg = g1_from_bytes(pks[0]) + g1_from_bytes(pks[1]) + g1_from_bytes(pks[2])
    assert multi_pairing([(-G1_GEN, g2_from_bytes(sig)), (agg, hash_to_g2(root))]).is_one()
    assert R > 0


def test_cancelling_pair_passes_only_without_coefficients():
    k_d, root_d = traffic.tamper_point_seed(11)
    d = bank.sign(k_d, root_d)
    sets = []
    for i, sign_d in ((1, d), (2, bank.negate_signature(d))):
        root = bytes([i]) * 32
        sk = bank.interop_sk(i)
        sig = bank.add_signatures([bank.sign(sk, root), sign_d])
        sets.append(([bank.sk_to_pk(sk)], root, sig))
    assert bank.verify_sum(sets, [1, 1]) is True
    assert bank.verify_sum(sets, [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F]) is False
    assert bank.verify_one(sets[0][0][0], sets[0][1], sets[0][2]) is False


def test_the_pure_python_reference_agrees_with_the_c_one():
    """Good, wrong-root, aggregate, +D and +E sets: the same verdicts."""
    root = b"\x05" * 32
    d = bank.sign(*traffic.tamper_point_seed(3))
    e = bank.sign(*traffic.tamper_point_seed(3, "E"))
    good = bank.sign(bank.interop_sk(4), root)
    agg = bank.sign_sum([bank.interop_sk(k) for k in (4, 6)], root)
    tasks = [((4,), root, good), ((4,), b"\x06" * 32, good), ((4, 6), root, agg),
             ((4,), root, bank.add_signatures([good, d])),
             ((4,), root, bank.add_signatures([good, e]))]
    assert bank.verify_tasks(tasks) == [True, False, True, False, False]
    assert pyref_check.verify_tasks(tasks) == [True, False, True, False, False]
    assert d != e
    assert pyref_check.interop_sk(9) == bank.interop_sk(9)


def test_the_pure_python_sample(tiny_config):
    """Every tampered set, some of the blocks', the rest drawn by the seed."""
    jobs = traffic.schedule(tiny_config, {"sets_per_s": 30.0, "tampered_gossip": {
        "pairs_at": [0.2, 0.45, 0.7], "single_at": 0.9}}, 41, 36)
    flat = [(j.topic, s) for j in jobs for s in j.sets]
    got = harness.pyref_sample(jobs, 41, 40)
    assert len(got) == len(set(got)) == 40 and got == sorted(got)
    assert {i for i, (_, s) in enumerate(flat) if s.tamper} <= set(got)
    assert sum(flat[i][0] == "beacon_block" and not flat[i][1].tamper
               for i in got) == harness.PYREF_BLOCK_SETS
    assert got == harness.pyref_sample(jobs, 41, 40)
    assert got != harness.pyref_sample(jobs, 42, 40)
